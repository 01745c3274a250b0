"""Speaker layouts and HRIR channel maps."""
