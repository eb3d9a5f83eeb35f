"""Photo-content exactness of tpujpeg_torch's fused chain, slots against
the classic scatter: the counterpart of tools/check_photo_exact.py.

A chunk of 64 restart streams: tests/fixtures/rst640 x 4, the JAX
tool's first 16 pictures (bench._make_photo_image(640, i), q90, a
restart marker every MCU row) four times each, where the JAX tool had
64 distinct ones.  It goes through fused.decode_chunk_fused with
slots=False (the classic scatter) and slots=256 (the slot route), f32
colour as in the JAX tool:

  * no error latch (malformed, envelope, slot overflow);
  * rgb, coefficients and risk bits equal between the two routes;
  * image 0 against the oracle: equal outside the risk mask
    (ops/color.unpack_mask), within +-1 inside it (the JAX engine
    repairs those from exact coefficients; the raw chain's rgb comes
    before any repair); and the chain with exact=True equals the oracle
    everywhere.

Exit 0 when every check holds.

    python tools/check_torch_photo_exact.py [--images-dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as tc  # noqa: E402


SLOT_C = 256
IMAGES = 64


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("photo check failed: " + msg)


def check(datas: list[bytes], dev, slot_c: int = SLOT_C) -> dict:
    """Run the checks on a restart chunk; raises RuntimeError on the
    first that fails, returns what it read."""
    import numpy as np
    import torch

    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch.ops import fsm
    from tpujpeg_torch.ops.color import unpack_mask
    from tpujpeg_torch.oracle import decoder as oracle
    from tpujpeg_torch.pipeline import Geometry
    from tpujpeg_torch.runtime import fused

    imgs = [parse(d) for d in datas]
    plan = fsm.build_plan(imgs, split=False)
    geom = Geometry.of(imgs[0])
    up = (torch.as_tensor(plan.xs).to(dev),
          torch.as_tensor(plan.seg_n_blocks).to(dev))
    quant = tc.quant(imgs, dev)
    B = len(imgs)
    out = {}
    for slots in (False, slot_c):
        rgb, risk, coeffs, dc, mal, env, slot = fused.decode_chunk_fused(
            plan, quant, geom, B, uploaded=up, slots=slots)
        require(not bool((mal | env | slot).any()),
                f"slots={slots}: an error lane latched")
        out[slots] = (rgb.cpu().numpy(), coeffs.cpu().numpy(),
                      dc.cpu().numpy(), risk.cpu().numpy())
    for i, what in enumerate(("rgb", "coefficients", "DC", "risk bits")):
        require(np.array_equal(out[False][i], out[slot_c][i]),
                f"slots={slot_c} {what} != the classic scatter's")
    ref = oracle.decode(imgs[0]).astype(np.uint8)
    got = out[slot_c][0][0].transpose(1, 2, 0)
    mask = unpack_mask(out[slot_c][3][0], geom.width)
    mism = (got != ref).any(-1)
    require(not (mism & ~mask).any(), "a pixel outside the risk mask differs")
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    require(diff.max() <= 1, "a risk pixel lies beyond +-1")
    exact = fused.decode_chunk_fused(plan, quant, geom, B, uploaded=up,
                                     slots=slot_c, want_coeffs=False,
                                     exact=True)[0]
    require(np.array_equal(exact[0].cpu().numpy().transpose(1, 2, 0), ref),
            "exact=True differs from the oracle")
    return {"images": B, "distinct": tc.distinct(datas),
            "risk_pixels": int(mask.sum()), "risk_mismatches": int(
                mism.sum()), "lanes": int(plan.xs.shape[0])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images-dir", default=None,
                    help="restart streams of this directory in place of "
                         "tests/fixtures/rst640")
    tc.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = tc.device(args.device)
    if args.images_dir:
        datas = tc.repeat([d for _, d in tc.read_dir(args.images_dir)],
                          IMAGES)
    else:
        datas = tc.corpus("rst640", IMAGES)
    r = check(datas, dev)
    print(f"PHOTO-SHAPE EXACTNESS OK ({r['images']} images, {r['distinct']} "
          f"distinct; slots={SLOT_C} == classic; oracle exact outside "
          f"{r['risk_mismatches']} risk pixels of {r['risk_pixels']} "
          f"flagged, all +-1; exact colour == oracle) [{tc.card(dev)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
