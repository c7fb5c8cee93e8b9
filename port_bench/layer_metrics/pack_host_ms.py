"""Host milliseconds a frame of the scene pack (``render.pack``, self time:
render_chunk's pack_scene_auto, the leaf pack ordered from the camera)."""

from port_bench import program_spans


def read(run):
    return program_spans.self_ms_a_frame(run, ("render.pack",))
