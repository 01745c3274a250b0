"""x_realtime (audio_s/s, end to end, host clock): audio seconds rendered
over all lanes in the window, over the wall seconds of the whole window,
every synchronisation included."""


def read(run):
    if not run.window_s:
        return None
    audio_s = run.lanes * run.frames_per_step * run.window_steps / run.sample_rate
    return audio_s / run.window_s
