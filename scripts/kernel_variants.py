"""Write copies of a checkout of the port with one compiled choice of the
sorted scheduler's integrate step (csrc/wavefront_kernel.cu) or the dense
intersect (csrc/intersect_kernel.cu) changed, for timing with
``chip_smoke.py --ab``:

    python scripts/kernel_variants.py CHECKOUT OUT_DIR VARIANT [VARIANT ...]
    python3 chip_smoke.py --ab CHECKOUT OUT_DIR/VARIANT ...

Each variant becomes OUT_DIR/VARIANT (':' written '_') holding the edited
``spectral_tpu_torch`` package. A part, a build with some of the kernel's
work compiled out, gets a TIMING_ONLY file beside it: its outputs are wrong
by design, and ``--ab`` times it without holding it to the digests; every
other variant must give this checkout's outputs bit for bit. An edit whose
anchor text is missing from the checkout's source, or found more than
once, raises.

Parts of the integrate kernel that writes each sample-ray's XYZ at its
original index, the spp sum left to PyTorch adds (``per_ray:``):

- ``per_ray:nostage``: the tables read from device memory, not staged in
  shared memory;
- ``per_ray:loads``: no table staging and no arithmetic: the state rows and
  the original index read, their sum stored coalesced at the sorted index;
- ``per_ray:stores``: no state read and no table staging: the original
  index read and the three scattered stores of the XYZ;
- ``per_ray:noscatter``: the whole kernel, its XYZ stored at the sorted
  index instead of the original one.

Parts of the integrate step (``slots:``), whose first kernel stores each
sample-ray's XYZ in a slot and whose second adds each pixel's slots:

- ``slots:nostage``: the CIE pairs read from device memory, not staged in
  shared memory;
- ``slots:loads``: the state rows and the original index read, their sum
  stored coalesced at the sorted index; no tables, no arithmetic;
- ``slots:nomath``: no XYZ arithmetic: the loads' sum goes to the slot;
- ``slots:noscatter``: each slot stored at the sorted index instead of the
  original one;
- ``slots:nosum``: the first kernel alone, no second launch.

Variants of the integrate step, bit-equal:

- ``slots:block128``: blocks of 128 threads instead of 256.

Variants of the dense intersect, bit-equal:

- ``intersect:rays1``, ``intersect:rays4``: 1 or 4 rays a thread instead of
  2;
- ``hit:branchy``: hit.cuh's triangle test combining its tests with &&, so
  that a branch skips each later test (every kernel that sweeps triangles
  changes with it).
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

CSRC = Path("spectral_tpu_torch") / "csrc"
WAVEFRONT = "wavefront_kernel.cu"
INTERSECT = "intersect_kernel.cu"
HIT = "hit.cuh"

_STAGE = """  __shared__ float s_tab[5 * kSamples];
  stage(s_tab, tables, 5 * kSamples);
  __syncthreads();
"""
_LOADS = """  float power[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) power[w] = state[(kRowPower + w) * nrays + i];
"""
_PER_RAY_MATH = """  Curves cv;
  hero_curves(hero, s_tab, cv);
  float sx, sy, sz;
  path_xyz(power, n_valid, cv, s_tab, sx, sy, sz);
  xyz[3 * (size_t)o] = sx;
  xyz[3 * (size_t)o + 1] = sy;
  xyz[3 * (size_t)o + 2] = sz;
"""
_LOAD_SUM = """  float sum = hero + n_valid + (float)o;
#pragma unroll
  for (int w = 0; w < kW; ++w) sum += power[w];
  xyz[i] = sum;
  return;
"""

def _w(edits):
    return [(WAVEFRONT, a, r) for a, r in edits]


VARIANTS = {
    # parts of the per-ray kernel (timing only)
    "per_ray:nostage": (True, _w([(_STAGE, "  const float* s_tab = tables;\n")])),
    "per_ray:loads": (True, _w([(_STAGE, "  const float* s_tab = tables;\n"),
                                (_LOADS + _PER_RAY_MATH, _LOADS + _LOAD_SUM)])),
    "per_ray:stores": (True, _w([
        (_STAGE, "  const float* s_tab = tables;\n"),
        ("  const int o = orig[i];\n  const float hero",
         "  const int o = orig[i];\n  xyz[3 * (size_t)o] = (float)i;\n  xyz[3 * (size_t)o + 1] = (float)i;\n"
         "  xyz[3 * (size_t)o + 2] = (float)i;\n  return;\n  const float hero"),
    ])),
    "per_ray:noscatter": (True, _w([(_PER_RAY_MATH, _PER_RAY_MATH.replace("(size_t)o", "(size_t)i"))])),
    # parts of the integrate step (timing only)
    "slots:nostage": (True, _w([
        ("""  __shared__ float4 s_xy[kSamples - 1];
  __shared__ float2 s_z[kSamples - 1];
""", ""),
        ("""  for (int c = threadIdx.x; c < kSamples - 1; c += blockDim.x) {
    const float* x = tables + kCieX * kSamples + c;
    const float* y = tables + kCieY * kSamples + c;
    const float* z = tables + kCieZ * kSamples + c;
    s_xy[c] = make_float4(x[0], x[1], y[0], y[1]);
    s_z[c] = make_float2(z[0], z[1]);
  }
  __syncthreads();
""", ""),
        ("""    const float4 xy = s_xy[cell];
    const float2 z = s_z[cell];
""", """    const float* tx = tables + cell;
    const float4 xy = make_float4(tx[0], tx[1], tx[kSamples], tx[kSamples + 1]);
    const float2 z = make_float2(tx[2 * kSamples], tx[2 * kSamples + 1]);
"""),
    ])),
    "slots:loads": (True, _w([
        ("  // XYZ of the sample-ray: path.cuh::path_xyz, each lut read as a pair\n",
         _LOAD_SUM.replace("xyz[i] = sum;", "reinterpret_cast<float*>(slot)[i] = sum;")),
    ])),
    "slots:nomath": (True, _w([
        ("  slot[o] = make_float4(sx, sy, sz, 0.0f);\n",
         "  sx = hero + n_valid;\n  sy = power[0];\n  sz = power[1];\n  slot[o] = make_float4(sx, sy, sz, 0.0f);\n"),
    ])),
    "slots:noscatter": (True, _w([("  slot[o] = make_float4(sx, sy, sz, 0.0f);\n",
                                   "  slot[i] = make_float4(sx, sy, sz, 0.0f);\n")])),
    "slots:nosum": (True, _w([("  sum_slots_kernel<<<(n + kIntegrateBlock - 1) / kIntegrateBlock,\n"
                               "                     kIntegrateBlock, 0, st>>>(slots, n, spp, xyz);\n", "")])),
    # variants of the integrate step (bit-equal)
    "slots:block128": (False, _w([("constexpr int kIntegrateBlock = 256;", "constexpr int kIntegrateBlock = 128;")])),
    # variants of the dense intersect (bit-equal)
    "intersect:rays1": (False, [(INTERSECT, "constexpr int kRays = 2;", "constexpr int kRays = 1;")]),
    "intersect:rays4": (False, [(INTERSECT, "constexpr int kRays = 2;", "constexpr int kRays = 4;")]),
    "hit:branchy": (False, [
        (HIT, "  bool inside = (fabsf(nd) >= SPT_DENOM_EPS) & (tt >= 0.0f);\n", "  bool inside = true;\n"),
        (HIT, "    inside = inside & (fmaf(tt, ad, ao) >= 0.0f);\n  }\n  return inside;\n",
         "    inside = inside && (fmaf(tt, ad, ao) >= 0.0f);\n  }\n"
         "  return inside && fabsf(nd) >= SPT_DENOM_EPS && tt >= 0.0f;\n"),
    ]),
}


def write_variant(checkout: Path, out: Path, name: str) -> Path:
    """OUT/NAME (':' written '_'): the checkout's package with the
    variant's edits; returns its directory."""
    timing_only, edits = VARIANTS[name]
    dst = out / name.replace(":", "_")
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(checkout / "spectral_tpu_torch", dst / "spectral_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, anchor, repl in edits:
        path = dst / CSRC / source
        text = path.read_text()
        if text.count(anchor) != 1:
            raise SystemExit(f"{name}: anchor found {text.count(anchor)} times in {checkout / CSRC / source}:\n{anchor}")
        path.write_text(text.replace(anchor, repl))
    if timing_only:
        (dst / "TIMING_ONLY").write_text(f"{name}: part of a kernel compiled out, for timing only\n")
    return dst


def main(argv: list[str]) -> int:
    if len(argv) < 3 or any(v not in VARIANTS for v in argv[2:]):
        print(__doc__, file=sys.stderr)
        print("variants:", ", ".join(VARIANTS), file=sys.stderr)
        return 2
    checkout, out = Path(argv[0]), Path(argv[1])
    for name in argv[2:]:
        print(write_variant(checkout, out, name))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
