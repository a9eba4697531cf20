"""Time variants of the three kernels' build constants on the card.

    python3 tools/kernel_variants.py [OUT_DIR]

Each variant is a copy of ``ic_gvins_tpu_torch/csrc/`` with one constant
rewritten, built by the port's ``_build.load`` into ``OUT_DIR/<variant>/``
(default ``build/variants``) and bound in place of the port's library. The
kernels run on ``chip_smoke.py``'s frame-0 inputs (the CLAHE tables of frame
0; the fused LK's 256 slots of the frame 0 -> 1 pair, both directions; the
subpix call on the slice's 210 detected corners of frame 0) and are timed
device-only (CUDA events around 50 queued calls) in two rounds, each
checked against its plain version. Some variants change what is computed,
to split the time: ``clahe_copy`` writes the gray value instead of the
blend (the same bytes, no table lookups), ``lk_steps0`` / ``lk_steps1`` cap
the LK steps per level (the levels' setup alone) and ``subpix_steps0`` /
``subpix_steps1`` the subpix steps (launch and staging alone);
``subpix_fixed20`` runs every corner's 20 steps (no stop test) and
``subpix_fixed20_noshfl`` drops the shuffle rounds of its block sums: the
shuffles' share of a step. ``subpix_ieeediv`` and ``subpix_sqrtstop`` put
back the IEEE division of the solve and the square root of the stop test.
Each line names the card.
"""

import re
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ic_gvins_tpu_torch.ops import _build  # noqa: E402
from ic_gvins_tpu_torch.ops import clahe as kclahe  # noqa: E402
from ic_gvins_tpu_torch.ops import lk as klk  # noqa: E402
from ic_gvins_tpu_torch.ops import subpix as ksubpix  # noqa: E402
from ic_gvins_tpu_torch.vision import camera as cam  # noqa: E402
from ic_gvins_tpu_torch.vision import features as feat  # noqa: E402
from ic_gvins_tpu_torch.vision import pyramid  # noqa: E402

CL, LK, SP = "clahe_apply.cu", "lk_pyr.cu", "subpix.cu"
VARIANTS = [
    ("base", []),
    ("clahe_rows4", [(CL, r"ROWS = 8;", "ROWS = 4;")]),
    ("clahe_rows16", [(CL, r"ROWS = 8;", "ROWS = 16;")]),
    ("clahe_threads256", [(CL, r"THREADS = 128;", "THREADS = 256;")]),
    ("clahe_copy", [(CL, r"res\[k\] = acc;", "res[k] = static_cast<float>(val[r][k]);")]),
    ("lk_threads64", [(LK, r"THREADS = 128;", "THREADS = 64;")]),
    ("lk_threads256", [(LK, r"THREADS = 128;", "THREADS = 256;")]),
    ("lk_margin3", [(LK, r"MARGIN = 5;", "MARGIN = 3;")]),
    ("lk_margin8", [(LK, r"MARGIN = 5;", "MARGIN = 8;")]),
    ("lk_steps0", [(LK, r"MAX_ITERS = 30;", "MAX_ITERS = 0;")]),
    ("lk_steps1", [(LK, r"MAX_ITERS = 30;", "MAX_ITERS = 1;")]),
    ("subpix_threads32", [(SP, r"THREADS = 128;", "THREADS = 32;")]),
    ("subpix_threads64", [(SP, r"THREADS = 128;", "THREADS = 64;")]),
    ("subpix_margin2", [(SP, r"MARGIN = 8;", "MARGIN = 2;")]),
    ("subpix_margin5", [(SP, r"MARGIN = 8;", "MARGIN = 5;")]),
    ("subpix_reach", [(SP, r"MARGIN = 8;", "MARGIN = ITERS;")]),
    ("subpix_steps0", [(SP, r"ITERS = 20;", "ITERS = 0;")]),
    ("subpix_steps1", [(SP, r"ITERS = 20;", "ITERS = 1;")]),
    ("subpix_fixed20", [(SP, r"if \(stop\) break;", "(void)stop;")]),
    ("subpix_fixed20_noshfl", [(SP, r"if \(stop\) break;", "(void)stop;"),
                               (SP, r"o > 0; o >>= 1", "o > 16; o >>= 1")]),
    ("subpix_ieeediv", [(SP, r"\) \* inv", ") / det")]),
    ("subpix_sqrtstop", [(SP, r"dx \* dx \+ dy \* dy < EPS \* EPS;",
                          "sqrtf(dx * dx + dy * dy) < EPS;")]),
]


def variant_lib(out_dir, tag, edits):
    """The port's sources with the edits applied, built and bound."""
    d = out_dir / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for name, pattern, repl in edits:
        text = (d / name).read_text()
        new = re.sub(pattern, repl, text)
        assert new != text, (tag, pattern)
        (d / name).write_text(new)
    return _build.load(d, d)


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT / "build" / "variants").resolve()
    card = cs.the_card(torch)
    dev = torch.device("cuda")
    _, _, _, images = cs.slice_world(cam)
    img0, img1 = (torch.tensor(images[k], dtype=torch.float32, device=dev) for k in (0, 1))
    tables = pyramid.clahe_tables(img0)
    pyr0, pyr1, pts, valid = cs.lk_inputs(torch, pyramid, feat, img0, img1)
    lk_args = (pyr0, pyr1, pts, pts, valid)
    sp_args = cs.subpix_inputs(torch, feat, pyr0[0])
    _, c, v = sp_args
    ref_c = kclahe.clahe_apply_plain(*tables)
    ref_f, ref_ok = klk.lk_pyr_plain(*lk_args)
    ref_steps = torch.zeros(c.shape[0], dtype=torch.int32, device=dev)
    ref_s = ksubpix.subpix_plain(*sp_args, steps=ref_steps)
    libs = {}
    for rnd in range(2):
        for tag, edits in VARIANTS:
            if tag not in libs:
                libs[tag] = variant_lib(out_dir, tag, edits)
            _build._lib = libs[tag]  # the wrappers launch through this variant
            out_c = kclahe.clahe_apply(*tables)
            fwd, ok = klk.lk_pyr(*lk_args)
            both = ok & ref_ok
            e = torch.linalg.vector_norm(fwd[both] - ref_f[both], dim=1)
            t_c = cs.cuda_ms(torch, lambda: kclahe.clahe_apply(*tables), reps=50, queued=True)
            t_l = cs.cuda_ms(torch, lambda: klk.lk_pyr(*lk_args), reps=50, queued=True)
            steps = torch.zeros_like(ref_steps)
            e_s = torch.linalg.vector_norm(ksubpix.subpix(*sp_args, iters=steps) - ref_s, dim=1)[v]
            t_s = cs.cuda_ms(torch, lambda: ksubpix.subpix(*sp_args), reps=50, queued=True)
            print(f"round {rnd} {tag:17s} clahe_apply {1e3 * t_c:7.2f} us (max diff vs plain "
                  f"{float((out_c - ref_c).abs().max()):.2e})  lk_pyr {1e3 * t_l:7.2f} us "
                  f"(ok agree {float((ok == ref_ok).float().mean()):.4f}, median diff "
                  f"{float(e.median()):.1e} px)  subpix {1e3 * t_s:7.2f} us (median diff "
                  f"{float(e_s.median()):.1e} px, steps equal "
                  f"{float((steps == ref_steps)[v].float().mean()):.4f})  ({card})")
    _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
