"""Host milliseconds a frame or a step of the program, less its waits on the
card: the request spans' total less that of the wait spans inside them,
over the request spans' count. One quantity, split by the end-to-end metric
it moves: ``host_ms.render`` (``render.frame`` less ``render.wait``:
RenderManager, the pack, the kernels' launches and the sorted scheduler's
glue, the image) and ``host_ms.train`` (``train.step``: train_step_fused's
pack, launches, wrappers and update, which wait on no copy)."""

from port_bench import program_spans

# traffic kind -> (request span, the wait spans inside it)
REQUESTS = {"render": ("render.frame", ("render.wait",)), "train": ("train.step", ())}


def read(run):
    spans = program_spans.summary(run)
    request, waits = REQUESTS.get(run.traffic["kind"], (None, ()))
    if spans is None or request not in spans:
        return None
    host_s = spans[request]["total_s"] - sum(spans[w]["total_s"] for w in waits if w in spans)
    return 1e3 * host_s / spans[request]["count"]
