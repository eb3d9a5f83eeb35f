"""The port's tools and benchmarks (tools/*torch*.py,
benchmarks/bench_torch_*.py) and the three helpers they brought into
tpujpeg_torch, on the CPU at a tiny size, against the JAX package and
its tools where there is a counterpart.

  * `color.unpack_mask`, `color.ycbcr_to_rgb` and `idct.idct_blocks`
    against the JAX functions on seeded numpy inputs: `==`, and for the
    f32 colour the rule of tests/test_torch_pixels.py (risk masks equal,
    rgb equal outside them);
  * the goldens tool's lines `==` tools/golden_check.py --backend
    oracle's; the bulk decoder's manifest (names, statuses, messages) and
    .array files `==` tools/batch_decode.py --backend oracle --format
    array's on a directory with a truncated stream, and --resume decodes
    no image again that decoded;
  * the fused-cut records have every cut, on a restart and a speculative
    chunk, and the cut checksums equal the sums of the stages' outputs;
  * the colour proof on a stride subset: 0 unflagged mismatches, and
    ycbcr_to_rgb's `risky` covers every mismatch against
    ycbcr_to_rgb_exact on every 64th Y slab;
  * benchmarks/plot_results.parse_runtime reads the runtime tool's lines;
    the runtime, throughput and sustained records carry the JAX tools'
    field names (read from their sources);
  * each tool defaults to the card and raises without one; the dataset
    and display tools equal the JAX ones' outputs.

Tolerance 0 everywhere but the stated f32 risk rule.  Streams come from
the conftest encoders with fixed seeds; the kernels run their plain
versions on CPU tensors.
"""

import ast
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujpeg.ops import color as jcolor
from tpujpeg.ops import idct as jidct
from tpujpeg.oracle import decoder as joracle
from tpujpeg_torch.ops import color as tcolor
from tpujpeg_torch.ops import idct as tidct

from conftest import GOLDEN, fixture_path, make_jpeg, make_jpeg_rst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
BENCHMARKS = os.path.join(ROOT, "benchmarks")
for _p in (TOOLS, BENCHMARKS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import batch_torch_decode  # noqa: E402
import bench_torch_runtime  # noqa: E402
import bench_torch_sustained  # noqa: E402
import bench_torch_throughput  # noqa: E402
import build_torch_dataset  # noqa: E402
import check_torch_color_device  # noqa: E402
import check_torch_goldens  # noqa: E402
import check_torch_photo_exact  # noqa: E402
import display_torch_array  # noqa: E402
import profile_torch_fused  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def rst_dir(tmp_path_factory):
    """Three tiny restart streams (a marker every MCU), one geometry."""
    d = tmp_path_factory.mktemp("rst")
    for i in range(3):
        (d / f"{i:02d}.jpg").write_bytes(
            make_jpeg_rst(shape=(16, 24), rst_interval=1, seed=i))
    return str(d)


def _write_dir(d, datas):
    for i, data in enumerate(datas):
        (d / f"{i:02d}.jpg").write_bytes(data)
    return str(d)


# -- the three helpers ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_idct_blocks_equals_jax(seed):
    rng = np.random.default_rng(seed)
    blocks = (rng.integers(-1024, 1024, (40, 8, 8))
              * rng.integers(1, 40, (40, 8, 8))).astype(np.int32)
    blocks[::3, 1:, :] = 0   # DC-heavy blocks too
    want = np.asarray(jidct.idct_blocks(jnp.asarray(blocks)))
    got = tidct.idct_blocks(torch.as_tensor(blocks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the same two passes as idct_planes
    planes = torch.as_tensor(blocks.reshape(40, 64).T.copy())
    np.testing.assert_array_equal(
        tidct.idct_planes(planes).numpy().T.reshape(40, 8, 8), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_ycbcr_to_rgb_agrees_with_jax(seed):
    rng = np.random.default_rng(seed)
    y, cb, cr = (rng.integers(-256, 256, (300, 7)).astype(np.int32)
                 for _ in range(3))
    y[0] = 0   # zero chroma rows: every pixel flagged
    cb[0] = cr[0] = 0
    want_rgb, want_risky = (np.asarray(a) for a in jcolor.ycbcr_to_rgb(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    rgb, risky = tcolor.ycbcr_to_rgb(*map(torch.as_tensor, (y, cb, cr)))
    assert rgb.dtype == torch.uint8 and tuple(rgb.shape) == (300, 7, 3)
    np.testing.assert_array_equal(risky.numpy(), want_risky)
    assert risky[0].all()
    safe = ~want_risky
    np.testing.assert_array_equal(rgb.numpy()[safe], want_rgb[safe])


@pytest.mark.parametrize("width", [8, 13, 61])
def test_unpack_mask_equals_jax(width):
    rng = np.random.default_rng(width)
    mask = rng.random((3, 5, width)) < 0.3
    packed = tcolor.pack_mask(torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(packed,
                                  np.asarray(jcolor.pack_mask(mask)))
    got = tcolor.unpack_mask(packed, width)
    np.testing.assert_array_equal(got, jcolor.unpack_mask(packed, width))
    np.testing.assert_array_equal(got, mask)


# -- goldens and the bulk decoder -------------------------------------------


def test_goldens_lines_equal_the_jax_tools(capsys):
    import golden_check

    assert golden_check.main(["--backend", "oracle"]) == 0
    want = capsys.readouterr().out
    assert want.splitlines()[-1] == f"{len(GOLDEN)}/{len(GOLDEN)} matched"
    for backend in ("oracle", "cuda"):
        assert check_torch_goldens.main(["--backend", backend] + CPU) == 0
        assert capsys.readouterr().out == want


def test_goldens_batch_backend_and_a_mismatch(tmp_path, capsys):
    # decode_batch (the fsm engine) on a small stream whose reference is
    # the oracle's output; a wrong reference prints MISMATCH, exit 1
    from tpujpeg_torch.io.arrayio import write_array
    from tpujpeg_torch.oracle import decoder as toracle

    (tmp_path / "s.jpg").write_bytes(
        make_jpeg_rst(shape=(16, 24), rst_interval=1, seed=5))
    ref = toracle.decode_file(str(tmp_path / "s.jpg"))
    write_array(str(tmp_path / "s.array"), ref)
    assert check_torch_goldens.main(["--backend", "batch", "--images",
                                     str(tmp_path)] + CPU) == 0
    assert capsys.readouterr().out == "s: MATCH\n1/1 matched\n"
    ref[0, 0, 0] = (int(ref[0, 0, 0]) + 3) % 256
    write_array(str(tmp_path / "s.array"), ref)
    assert check_torch_goldens.main(["--backend", "oracle", "--images",
                                     str(tmp_path)]) == 1
    assert "s: MISMATCH (max diff 3)" in capsys.readouterr().out


def _manifest(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def test_bulk_decode_equals_the_jax_tool_and_resumes(tmp_path, capsys):
    import batch_decode

    src = tmp_path / "in"
    src.mkdir()
    shutil.copy(fixture_path("3_120x120"), src / "a.jpg")
    shutil.copy(fixture_path("3_120x120"), src / "b.jpg")
    with open(fixture_path("6_225x168"), "rb") as f:
        (src / "c_truncated.jpg").write_bytes(f.read()[:3000])
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    assert batch_decode.main([str(src), str(jout), "--backend", "oracle",
                              "--format", "array"]) == 0
    argv = [str(src), str(tout), "--backend", "host", "--format",
            "array"] + CPU
    assert batch_torch_decode.main(argv) == 0
    want = _manifest(jout / "manifest.jsonl")
    got = _manifest(tout / "manifest.jsonl")
    fields = ("name", "status", "error")
    assert [[r.get(k) for k in fields] for r in got] == \
        [[r.get(k) for k in fields] for r in want]
    assert [r["status"] for r in got] == ["ok", "ok", "error"]
    for name in ("a", "b"):
        assert (tout / f"{name}.array").read_bytes() == \
            (jout / f"{name}.array").read_bytes()
    capsys.readouterr()
    # resume: the two that decoded are skipped, the truncated one is tried
    # again (the JAX tool's rule) and fails again
    assert batch_torch_decode.main(argv + ["--resume"]) == 0
    assert "resume: 2 already done, 1 remaining" in capsys.readouterr().out
    again = _manifest(tout / "manifest.jsonl")
    assert again[:3] == got and len(again) == 4
    assert again[3]["name"] == "c_truncated.jpg"
    assert again[3]["status"] == "error"


def test_bulk_decode_png_and_fsm(tmp_path, rst_dir):
    # --format png through PIL, backend fsm (the plain kernels on the CPU)
    from PIL import Image

    from tpujpeg_torch.oracle import decoder as toracle

    out = tmp_path / "out"
    assert batch_torch_decode.main([rst_dir, str(out), "--backend", "fsm",
                                    "--chunk", "2"] + CPU) == 0
    recs = _manifest(out / "manifest.jsonl")
    assert [r["status"] for r in recs] == ["ok"] * 3
    for r in recs:
        got = np.asarray(Image.open(r["out"]))
        want = toracle.decode_file(os.path.join(rst_dir, r["name"]))
        np.testing.assert_array_equal(got, want)


# -- the fused cuts -----------------------------------------------------------


def test_fused_cut_records_have_every_cut(rst_dir, tmp_path, capsys):
    out = tmp_path / "cuts.jsonl"
    assert profile_torch_fused.main(
        ["--images-dir", rst_dir, "--images", "3", "--iters", "1", "--slots",
         "off", "--out", str(out)] + CPU) == 0
    printed = capsys.readouterr().out
    assert "restart chain" in printed and "per-chunk ceiling" in printed
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["cut"] for r in recs] == list(profile_torch_fused.CUTS)
    for r in recs:
        assert {"cut", "cumulative_ms", "stage_ms", "corpus",
                "slots"} <= r.keys()
        assert r["slots"] == "off" and r["cumulative_ms"] > 0


def test_fused_cuts_of_the_spec_chain():
    # no restart markers: the speculative chain's cuts (256-byte lanes;
    # the plain scans take seconds, so one record), the scan and assemble
    # checksums the sums of their stages' whole outputs
    from tpujpeg_torch.ops import fsm
    from tpujpeg_torch.runtime import fused

    datas = [make_jpeg(shape=(16, 24), seed=s) for s in (1, 2)]
    cpu = torch.device("cpu")
    st = profile_torch_fused.stage(datas, cpu, chunk_bytes=256)
    assert st.kind == "spec"
    recs = profile_torch_fused.cut_records(st, cpu, cuts=("materialize",),
                                           iters=1, slots=None,
                                           corpus="spec", slots_arg="auto")
    assert [r["cut"] for r in recs] == ["materialize"]
    assert recs[0]["cumulative_ms"] > 0
    B = len(datas)
    p = fsm.spec_sync_start(st.imgs, plan=st.plan, xs_dev=st.xs)
    assert torch.equal(profile_torch_fused.cut_fn(st, "scan")()[0],
                       fused._sum32(p.ev1, p.anchors, p.ablk, p.recm, p.ev2,
                                    p.end2, p.b1, p.blk2, p.packed))
    full = fused.decode_spec_sync_fused(p, st.geom, st.quant, B, B)
    assert torch.equal(profile_torch_fused.cut_fn(st, "assemble")()[0],
                       fused._sum32(full[2], full[3]))
    with pytest.raises(ValueError):
        fused.decode_spec_sync_fused(p, st.geom, st.quant, B, B,
                                     stop_after="pixels")


def test_fused_cut_checksums_of_the_restart_chain(rst_dir):
    datas = [open(os.path.join(rst_dir, n), "rb").read()
             for n in sorted(os.listdir(rst_dir))]
    st = profile_torch_fused.stage(datas, torch.device("cpu"))
    assert st.kind == "restart"
    profile_torch_fused.check_checksums(st)


# -- the colour proof ---------------------------------------------------------


def test_colour_proof_on_a_stride_subset(tmp_path, capsys):
    out = tmp_path / "proof.json"
    assert check_torch_color_device.main(
        ["--stride", "64", "--chroma-stride", "8", "--out", str(out)]
        + CPU) == 0
    assert "PROOF HOLDS" in capsys.readouterr().out
    rec = json.loads(out.read_text())
    assert rec["checked"] == 8 * 64 * 64
    for k in ("exact_kernel_mismatches", "exact_torch_mismatches",
              "f32_kernel_unflagged_mismatches",
              "f32_torch_unflagged_mismatches"):
        assert rec[k] == 0, k
    assert rec["first_unflagged"] is None
    # the kernel's f32 mode and ycbcr_to_rgb flag the same triples here
    assert 0 < rec["f32_kernel_flagged"] == rec["f32_torch_flagged"]


def test_f32_risk_covers_every_mismatch_on_the_subset():
    # every 64th Y slab, all 512 x 512 chroma pairs
    axis = np.arange(-256, 256, dtype=np.int32)
    cb, cr = (a.ravel() for a in np.meshgrid(axis, axis, indexing="ij"))
    flagged = 0
    for y in range(-256, 256, 64):
        yy = np.full(cb.size, y, np.int32)
        rgb, risky = tcolor.ycbcr_to_rgb(*map(torch.as_tensor, (yy, cb, cr)))
        want = joracle.ycbcr_to_rgb_exact(yy, cb, cr)
        bad = (rgb.numpy() != want).any(axis=1)
        assert not (bad & ~risky.numpy()).any(), y
        flagged += int(risky.sum())
    assert flagged > 0


def test_colour_proof_finds_an_unflagged_mismatch(monkeypatch, tmp_path):
    # a colour that is off by one and flags nothing fails the proof
    from tpujpeg_torch.ops import pixels

    def wrong(y, cb, cr):
        rgb, risky = tcolor.ycbcr_to_rgb(y, cb, cr)
        return (rgb.to(torch.int32) + 1).clamp(0, 255).to(torch.uint8), \
            torch.zeros_like(risky)

    monkeypatch.setattr(pixels, "ycbcr_to_rgb", wrong)
    assert check_torch_color_device.main(
        ["--stride", "256", "--chroma-stride", "32",
         "--out", str(tmp_path / "p.json")] + CPU) == 1
    rec = json.loads((tmp_path / "p.json").read_text())
    assert rec["f32_torch_unflagged_mismatches"] > 0
    assert rec["f32_kernel_unflagged_mismatches"] == 0
    assert rec["exact_kernel_mismatches"] == rec["exact_torch_mismatches"] == 0
    assert rec["first_unflagged"][0] == "torch"


def test_photo_check(rst_dir, capsys):
    assert check_torch_photo_exact.main(["--images-dir", rst_dir] + CPU) == 0
    assert "PHOTO-SHAPE EXACTNESS OK (64 images, 3 distinct" in \
        capsys.readouterr().out


def test_photo_check_fails_on_a_latch():
    # a stream cut short latches an error lane: the check raises
    datas = [make_jpeg_rst(shape=(16, 24), rst_interval=1, seed=s)
             for s in (0, 1)]
    # stuffed 0xFF bytes after the scan header: 16 one bits in a row are
    # no Huffman code (the all-ones code is reserved), markers untouched
    sos = datas[1].index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(datas[1][sos + 2 : sos + 4], "big")
    bad = bytearray(datas[1])
    bad[start : start + 8] = b"\xff\x00" * 4
    with pytest.raises(RuntimeError, match="an error lane latched"):
        check_torch_photo_exact.check([datas[0], bytes(bad)],
                                      torch.device("cpu"))


# -- the benchmarks -----------------------------------------------------------


def _jax_keys(path: str, names=("rec", "summary")) -> set:
    """The string keys of every dict literal a JAX tool assigns to
    `names`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id in names
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
    assert keys
    return keys


def test_runtime_lines_parse_and_records(tmp_path, rst_dir, capsys):
    import plot_results

    out, jsonl = tmp_path / "rt.txt", tmp_path / "rt.jsonl"
    assert bench_torch_runtime.main(
        ["--sizes", "200", "400", "200", "--iters", "2", "--out", str(out),
         "--jsonl", str(jsonl)] + CPU) == 0
    by_size = plot_results.parse_runtime(str(out))
    assert sorted(by_size) == [200, 400]
    assert all(len(v) == 1 and v[0] > 0 for v in by_size.values())
    recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    want = _jax_keys(os.path.join(BENCHMARKS, "bench_runtime.py"))
    assert all(want <= r.keys() for r in recs)
    assert [r["path"] for r in recs] == ["synthetic/200x200.jpg",
                                         "synthetic/400x400.jpg"]
    assert recs[0]["bytes"] == os.path.getsize(
        os.path.join(bench_torch_runtime.SERIES, "200.jpg"))
    assert {r["backend"] for r in recs} == {"host"}
    assert bench_torch_runtime.REFERENCE_MS == plot_results.REFERENCE_MS
    # --images-dir, backend fsm
    capsys.readouterr()
    assert bench_torch_runtime.main(
        ["--images-dir", rst_dir, "--iters", "1", "--backend", "fsm",
         "--out", str(tmp_path / "d.txt")] + CPU) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.endswith("backend fsm") for ln in lines] == [False] + [True] * 3


def test_runtime_series_is_the_jax_benchmarks(tmp_path):
    # the committed series: bench_runtime's synthetic sizes, q90, a
    # restart marker every MCU row, 4:4:4
    from tpujpeg_torch.io.parser import parse_file

    for s in range(200, 2001, 200):
        img = parse_file(os.path.join(bench_torch_runtime.SERIES,
                                      f"{s}.jpg"))
        assert (img.width, img.height, img.sampling) == (s, s, "4:4:4")
        assert img.restart_interval == -(-s // 8)


def test_throughput_records_carry_the_jax_fields(tmp_path, rst_dir, capsys):
    jsonl = tmp_path / "tp.jsonl"
    assert bench_torch_throughput.main(
        ["--images-dir", rst_dir, "--batches", "2", "4", "--chunk", "2",
         "--workers", "1", "2", "--iters", "2", "--backend", "fsm",
         "--jsonl", str(jsonl)] + CPU) == 0
    recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    want = _jax_keys(os.path.join(BENCHMARKS, "bench_throughput.py"))
    assert [(r["workers"], r["batch"]) for r in recs] == \
        [(1, 2), (1, 4), (2, 2), (2, 4)]
    for r in recs:
        assert want <= r.keys()
        assert len(r["mb_per_s_samples"]) == 2 and r["backend"] == "fsm"
        assert r["chunks"] == r["batch"] // 2
    assert recs[1]["distinct"] == 3


def test_sustained_records_carry_the_jax_fields(tmp_path, rst_dir):
    out = tmp_path / "sus.jsonl"
    assert bench_torch_sustained.main(
        ["--images-dir", rst_dir, "--images", "8", "--windows", "2",
         "--chunk", "2", "--out", str(out)] + CPU) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    windows, summary = recs[:-1], recs[-1]
    want = _jax_keys(os.path.join(TOOLS, "bench_sustained.py"), ("rec",))
    assert len(windows) == 2
    for r in windows:
        assert want <= r.keys()
        assert r["device_MBps"] > 0 and r["MBps"] > 0
        assert r["backend"] == "fsm" and r["chunks"] == 2
    want = _jax_keys(os.path.join(TOOLS, "bench_sustained.py"),
                     ("summary",))
    assert want - {"sizes"} <= summary.keys()
    assert summary["window_metric"] == "device_MBps"
    assert summary["images"] == 8 and summary["distinct"] == 3
    with pytest.raises(SystemExit):
        bench_torch_sustained.main(["--device-only", "--backend", "host"]
                                   + CPU)


# -- defaults and the copies --------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("tool,argv", [
    (profile_torch_fused, []), (check_torch_color_device, []),
    (check_torch_photo_exact, []), (check_torch_goldens, []),
    (batch_torch_decode, ["in", "out", "--format", "array"]),
    (bench_torch_sustained, []), (bench_torch_runtime, []),
    (bench_torch_throughput, []),
], ids=lambda x: getattr(x, "__name__", ""))
def test_tools_default_to_the_card(tool, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main(argv)


def test_dataset_and_display_equal_the_jax_tools(tmp_path, capsys):
    import build_dataset
    import display_array

    src = tmp_path / "src"
    src.mkdir()
    for i, name in enumerate(["3_120x120", "5_200x200", "3_120x120"]):
        shutil.copy(fixture_path(name), src / f"{i}.jpg")
    (src / "bad.jpg").write_bytes(b"not a jpeg")
    assert build_dataset.main([str(src), str(tmp_path / "j"),
                               "--min-count", "1", "--copy"]) == 0
    want = capsys.readouterr().out.replace(str(tmp_path / "j"), "OUT")
    assert build_torch_dataset.main([str(src), str(tmp_path / "t"),
                                     "--min-count", "1", "--copy"]) == 0
    got = capsys.readouterr().out.replace(str(tmp_path / "t"), "OUT")
    assert got == want and "120x120: 2 images" in got
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    arr = fixture_path("3_120x120", ".array")
    assert display_array.main([arr, "-o", str(tmp_path / "j.png")]) == 0
    assert display_torch_array.main([arr, "-o", str(tmp_path / "t.png")]) \
        == 0
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
