"""Speaker layouts, HRIR channel maps, and the preset libraries: device
profiles, EQ and HRIR presets, latest-wins activation, bundled presets."""
