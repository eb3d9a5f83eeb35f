"""tpujpeg_torch several processes (parallel/distributed.py), for real.

Two processes join one gloo process group over localhost (as the JAX
package's test joins two jax.distributed processes), each decodes its
round-robin shard of six seeded streams (24 x 32 to 40 x 56 px) on the
CPU and checks it `==` the port's oracle, and the summed metrics must
count every image and byte once.  A configured coordinator that cannot
be reached raises within its timeout; nothing configured runs
standalone; shard_list is the JAX package's on every (index, count).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

from tpujpeg.parallel import distributed as jdist
from tpujpeg_torch.parallel import distributed as dist

from conftest import make_jpeg, make_jpeg_rst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch.distributed
    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch.oracle import decoder as oracle
    from tpujpeg_torch.parallel import distributed as dist
    from tpujpeg_torch.runtime.batch import BatchDecoder

    pid = int(sys.argv[1])
    dist.initialize(coordinator_address={addr!r}, num_processes=2,
                    process_id=pid, local_device_ids=[0],
                    initialization_timeout=60)
    dist.initialize()              # already initialized: nothing to do
    assert dist.process_info() == (pid, 2), dist.process_info()
    folder = {folder!r}
    paths = [f"{{folder}}/{{i}}.jpg" for i in range(6)]
    mine = dist.shard_list(paths)
    assert mine == paths[pid::2], mine
    datas = [open(p, "rb").read() for p in mine]
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    out = dec.decode(datas)
    dec.close()
    for got, d in zip(out, datas):
        assert np.array_equal(got, oracle.decode(parse(d))), "decode"
    totals = dist.allreduce_metrics(
        {{"images": len(datas), "bytes": float(sum(map(len, datas)))}})
    dist.barrier()
    torch.distributed.destroy_process_group()
    print(f"proc{{pid}} OK", [p[-5:] for p in mine], totals)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(script) -> list:
    addr = f"127.0.0.1:{_free_port()}"
    script.write_text(_WORKER.format(repo=REPO, addr=addr,
                                     folder=str(script.parent)))
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_processes_shard_decode_and_sum(tmp_path):
    datas = [make_jpeg_rst(shape=(24, 32), rst_interval=2, seed=s)
             for s in range(3)]
    datas += [make_jpeg(shape=(40, 56), seed=s) for s in range(3)]
    for i, d in enumerate(datas):
        (tmp_path / f"{i}.jpg").write_bytes(d)
    res = _run_pair(tmp_path / "worker.py")
    if any(rc for rc, _ in res) and any("EADDRINUSE" in out or
                                        "address already in use" in out
                                        for _, out in res):
        res = _run_pair(tmp_path / "worker.py")   # the free port was taken
    want = {"bytes": float(sum(map(len, datas))), "images": 6.0}
    for i, (rc, out) in enumerate(res):
        assert rc == 0, f"proc{i} failed:\n{out}"
        assert f"proc{i} OK" in out and repr(want) in out, out
    # disjoint and covering round-robin shards, printed by the workers
    assert "['0.jpg', '2.jpg', '4.jpg']" in res[0][1]
    assert "['1.jpg', '3.jpg', '5.jpg']" in res[1][1]


def test_configured_coordinator_failure_raises():
    # a coordinator IS configured but nothing listens (the discard port):
    # initialize raises within its timeout, never runs standalone
    with pytest.raises(RuntimeError):   # torch's DistNetworkError
        dist.initialize(coordinator_address="127.0.0.1:9", num_processes=2,
                        process_id=1, initialization_timeout=5)
    assert dist.process_info() == (0, 1)


@pytest.mark.parametrize("var", dist._COORDINATOR_ENV_VARS)
def test_coordinator_configured_by_environment(monkeypatch, var):
    for v in dist._COORDINATOR_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert not dist.coordinator_configured()
    assert dist.coordinator_configured(coordinator_address="h:1")
    monkeypatch.setenv(var, "1")
    assert dist.coordinator_configured()


def test_unconfigured_runs_standalone(monkeypatch):
    for v in dist._COORDINATOR_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    dist.initialize()  # a no-op, not an error
    assert dist.process_info() == (0, 1)
    metrics = {"images": 3, "bytes": 10.5}
    assert dist.allreduce_metrics(metrics) == metrics
    dist.barrier()
    with pytest.raises(TypeError, match="unknown"):
        dist.initialize(coordinator="h:1")


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_shard_list_equal_to_jax(count):
    items = list(range(11))
    shards = [dist.shard_list(items, index=i, count=count)
              for i in range(count)]
    assert shards == [jdist.shard_list(items, index=i, count=count)
                      for i in range(count)]
    assert sorted(x for s in shards for x in s) == items
    assert dist.shard_list(items) == items  # standalone: everything
