"""The traced window over the decode steps the engine merged in it
(``EngineStats.decode_steps``), in ms a step."""


def read(run):
    if run.timeline is None or not run.window.decode_steps:
        return None
    return run.timeline.window_s / run.window.decode_steps * 1e3
