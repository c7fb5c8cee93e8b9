"""Host milliseconds a frame of the sorted scheduler (self time of its
``sched.*`` spans: the leaf tables, the camera launch, each bounce's keys,
argsort and gathers, the bounce launches, the integrate step)."""

from port_bench import program_spans

SCHED = ("sched.tables", "sched.camera", "sched.sort", "sched.bounce", "sched.integrate")


def read(run):
    return program_spans.self_ms_a_frame(run, SCHED)
