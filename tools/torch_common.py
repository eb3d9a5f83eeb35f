"""Helpers shared by the port's tools and benchmarks (tools/*torch*.py,
benchmarks/bench_torch_*.py): the --device argument, timing on the card
or on the host, the committed corpora, a chunk's quant tables on a
device, the card's name and power limit, and host RSS.

Imports torch and tpujpeg_torch only, never jax or the tpujpeg package.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")


def device(name: str):
    """torch.device(name); raises where it names CUDA and no card is
    there."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA card here "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run the plain versions")
    return dev


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def times_ms(fn, dev, reps: int) -> list[float]:
    """fn() once to warm, then `reps` timed runs in milliseconds: CUDA
    events on a card, the host clock to a synchronize elsewhere."""
    import torch

    fn()
    sync(dev)
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def spread(times: list[float]) -> dict:
    """median, min and max of a list of times."""
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def read_dir(folder: str) -> list[tuple[str, bytes]]:
    """(name, bytes) of every .jpg / .jpeg in `folder`, sorted by name."""
    out = []
    for n in sorted(os.listdir(folder)):
        if n.lower().endswith((".jpg", ".jpeg")):
            with open(os.path.join(folder, n), "rb") as f:
                out.append((n, f.read()))
    return out


def corpus(name: str, count: int | None = None) -> list[bytes]:
    """The committed streams of tests/fixtures/<name>, repeated in order
    to `count` streams (all of them once by default)."""
    datas = [d for _, d in read_dir(os.path.join(FIXTURES, name))]
    if not datas:
        raise FileNotFoundError(f"no streams in tests/fixtures/{name}")
    return repeat(datas, count or len(datas))


def repeat(datas: list, count: int) -> list:
    return (datas * -(-count // len(datas)))[:count]


def distinct(datas: list[bytes]) -> int:
    return len(set(datas))


def quant(imgs, dev):
    """int32 [B, n_comp, 64] zigzag quant tables of parsed images."""
    import numpy as np
    import torch

    return torch.as_tensor(np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)).to(dev)


def card(dev) -> str:
    """nvidia-smi's "name, power.limit" of the card, or the device."""
    if dev.type != "cuda":
        return str(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=60)
        return smi.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e6


def trim() -> None:
    """Release freed arenas to the OS, so RSS reads live memory, not
    glibc's fragmentation."""
    import ctypes
    import gc

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


def write_jsonl(path: str, records: list[dict], mode: str = "a") -> None:
    import json

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, mode) as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
