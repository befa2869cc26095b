"""The device's milliseconds a frame in ``render_frame_3d``, by CUDA events
around it on the engine's stream."""


def read(run):
    if not run.render_ms:
        return None
    return sum(run.render_ms) / len(run.render_ms)
