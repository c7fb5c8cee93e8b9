"""CLI entry point — parity with the reference's main.cpp.

Port of spectral_tpu/main.py. Flow (main.cpp:135-167): parse args -> scene
-> render loop (progressive display) -> save/log. Display is a terminal
preview plus a refreshing PNG (no GUI on a GPU server; the CImg window
main.cpp:20-40 maps to the preview file); save writes a BMP under
``renders/`` like io/save_image.cpp.

Usage: python -m spectral_tpu_torch.main -s 0 -xr 600 -ns 500 -bl 10 --save --no-show
       (add --device cpu to run the plain PyTorch versions on the host, and
       --impl xla to render through the XLA-style wavefront renderer)
"""

from __future__ import annotations

import os
import sys

import torch

from .config import parse_args
from .io.image import save_image, save_render
from .models.scenes import SCENE_NAMES, build_scene, scene_camera
from .render.wavefront import xyz_to_image
from .runtime.render_manager import RenderManager
from .utils import trace
from .utils.device import resolve_device
from .utils.logging import LogContext, reset_log_context


def log_tallies(log: LogContext) -> None:
    """The run's spans and kernels (utils/trace.py::summary) as run-log
    entries: each span's count and self seconds, the kernel builds and
    their seconds, the launches of each kernel, the leaf packs built and
    served again, and the host's wait for the card's results."""
    s = trace.summary()
    spans = s["spans"]
    for name, d in sorted(spans.items()):
        log.add_entry(f"span {name} (count, self seconds)", f"{d['count']}, {d['self_s']:.6f}")
    builds = spans.get("kernel.build", {"count": 0, "total_s": 0.0})
    log.add_entry("kernel builds", builds["count"])
    log.add_entry("kernel build time (seconds)", builds["total_s"])
    for name, n in s["launches"].items():
        log.add_entry(f"launches {name}", n)
    log.add_entry("leaf packs (builds, reuses)", f"{s['leaf_packs']['builds']}, {s['leaf_packs']['reuses']}")
    log.add_entry("host wait (seconds)", spans.get("render.wait", {}).get("total_s", 0.0))


def main(argv: list[str] | None = None) -> int:
    p = parse_args(sys.argv[1:] if argv is None else argv)
    if not p.do_log:
        return _run(p)
    trace.reset()
    with trace.recording():
        return _run(p)


def _run(p) -> int:
    device = resolve_device(p.device)
    log = reset_log_context(p.title, p.log_subdir)

    log.add_entry("title", p.title)
    log.add_entry("scene", SCENE_NAMES.get(p.scene, str(p.scene)))
    log.add_entry("device", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")

    scene = build_scene(p.scene, device)
    cam = scene_camera(p.scene, p.xres, p.yres, device)
    if p.do_log:
        log.add_entry("scene build time (seconds)", trace.summary()["spans"]["scene.build"]["total_s"])
    log.add_entry("triangles", scene.num_tris)

    rm = RenderManager(scene, cam, p, log)

    preview_path = f"renders/{p.title}_preview.png"
    done = [0]
    total = sum(1 for _ in rm.chunks())

    display = None
    if p.show:
        from .io.display import TerminalDisplay

        display = TerminalDisplay(p.xres, p.yres)

    def on_chunk(c, fb_xyz):
        done[0] += 1
        print(
            f"\rchunk {done[0]}/{total} "
            f"({c.x0},{c.y0} {c.width}x{c.height})",
            end="",
            file=sys.stderr,
            flush=True,
        )
        if p.show:  # progressive live view (the CImg window analogue)
            img = xyz_to_image(torch.from_numpy(fb_xyz).to(device), p.nsamples).cpu().numpy()
            display.update(img)
            save_image(img, preview_path)

    if p.profile_dir:
        # profiler bracket around the render loop (main.cpp:28,57 analogue)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            img = rm.render(on_chunk)
        os.makedirs(p.profile_dir, exist_ok=True)
        trace_path = os.path.join(p.profile_dir, f"{p.title}_trace.json")
        prof.export_chrome_trace(trace_path)
        print(f"\nprofiler trace in {trace_path}", file=sys.stderr)
    else:
        img = rm.render(on_chunk)
    print("", file=sys.stderr)

    if p.save:
        path = save_render(img, p.title)
        print(f"saved {path}")
    if p.show:
        print(f"preview at {preview_path}")
    if p.do_log:
        log_tallies(log)
        path = log.to_file()
        print(f"log at {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
