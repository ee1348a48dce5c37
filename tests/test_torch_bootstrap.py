"""PyTorch port, the process group of a multi-process fit on the CPU
(spark_rapids_ml_torch/parallel/bootstrap.py and partitioner.py, gloo): the
SRML_TPU_* environment rendezvous and the file-based allgather control plane
(as tests/test_multihost_bootstrap.py drives the JAX package's) in spawned
ranks, the single-process no-op, adopting a default group the caller already
initialised, reset, the backend rule, a rendezvous that never completes, the
shared card's stream threshold and each rank's share of a streamed batch."""

import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.parallel import bootstrap, partitioner

REPO = Path(__file__).resolve().parents[1]
RANK_ENV = ("SRML_TPU_COORDINATOR", "SRML_TPU_NUM_PROCESSES", "SRML_TPU_PROCESS_ID")

# one rank: join the group (by the environment, or by the file allgather when
# argv[3] names a directory), then all-reduce, gather and broadcast a little
RANK = textwrap.dedent(
    """
    import datetime, json, os, sys, time
    import torch
    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.parallel import bootstrap, partitioner

    rank, world, rendezvous, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    config.set("device", "cpu")
    timeout = datetime.timedelta(seconds=60)

    def file_allgather(payload):
        mine = os.path.join(rendezvous, f"payload-{rank}")
        with open(mine + ".tmp", "w") as f:
            f.write(payload)
        os.rename(mine + ".tmp", mine)
        got = []
        for r in range(world):
            path = os.path.join(rendezvous, f"payload-{r}")
            for _ in range(1200):
                if os.path.exists(path):
                    break
                time.sleep(0.05)
            with open(path) as f:
                got.append(f.read())
        return got

    if rendezvous == "env":
        up = bootstrap.init_from_env(timeout=timeout)
    else:
        bootstrap.init_process_group(process_id=rank, allgather_fn=file_allgather, timeout=timeout)
        up = torch.distributed.is_initialized()
    part = partitioner.active_partitioner()
    (total,) = part.all_reduce_sum(torch.tensor([float(rank + 1)]))
    rows = part.all_gather_rows(torch.full((rank, 2), float(rank)))
    desc = part.descriptor(rank + 1, 4)
    sent = part.broadcast(torch.tensor([7.0 if rank == 0 else -1.0]))
    with open(out, "w") as f:
        json.dump({"up": up, "backend": torch.distributed.get_backend(),
                   "rank": part.process_index, "count": part.process_count,
                   "total": float(total[0]), "rows": rows.tolist(), "m": desc.m,
                   "offset": desc.offset, "broadcast": float(sent[0]),
                   "any": part.any(rank == world - 1),
                   "ops": partitioner.counters["comm.collective_ops"]}, f)
    bootstrap.reset_process_group()
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, world, rendezvous, env_of):
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), **env_of(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(r), str(world), rendezvous, str(tmp_path / f"r{r}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return [json.loads((tmp_path / f"r{r}.json").read_text()) for r in range(world)]


def _check_group(results, world):
    for r, res in enumerate(results):
        assert res["up"] and res["backend"] == "gloo"
        assert (res["rank"], res["count"]) == (r, world)
        assert res["total"] == world * (world + 1) / 2
        # rank r contributed r rows of the value r, gathered in rank order
        assert res["rows"] == [[float(q), float(q)] for q in range(world) for _ in range(q)]
        assert res["m"] == world * (world + 1) // 2 and res["offset"] == r * (r + 1) // 2
        assert res["broadcast"] == 7.0 and res["any"] is True
        # the all-reduce, 2 for the rows, the descriptor, the broadcast, any
        assert res["ops"] == 6


@pytest.mark.parametrize("world", [2, 3])
def test_the_environment_rendezvous(tmp_path, world):
    port = _free_port()
    results = _run_ranks(tmp_path, world, "env", lambda r: {
        "SRML_TPU_COORDINATOR": f"127.0.0.1:{port}", "SRML_TPU_NUM_PROCESSES": str(world),
        "SRML_TPU_PROCESS_ID": str(r)})
    _check_group(results, world)


def test_the_file_allgather_control_plane(tmp_path):
    """No rank knows the coordinator: rank 0 advertises host:port through the
    allgather, and the barrier's width is the process count."""
    rendezvous = tmp_path / "rendezvous"
    rendezvous.mkdir()
    port = str(_free_port())
    results = _run_ranks(tmp_path, 2, str(rendezvous), lambda r: {
        "SPARK_RAPIDS_ML_TPU_COORD_PORT": port})
    _check_group(results, 2)
    payloads = [(rendezvous / f"payload-{r}").read_text() for r in range(2)]
    assert payloads[1] == "" and payloads[0].endswith(f":{port}")


@pytest.fixture
def no_rank_env(monkeypatch):
    for key in RANK_ENV:
        monkeypatch.delenv(key, raising=False)
    yield
    bootstrap.reset_process_group()


def test_one_process_is_a_no_op(no_rank_env, monkeypatch):
    bootstrap.init_process_group(device="cpu")
    assert not dist.is_initialized()
    assert bootstrap.init_from_env(device="cpu") is False
    monkeypatch.setenv("SRML_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SRML_TPU_NUM_PROCESSES", "1")
    assert bootstrap.init_from_env(device="cpu") is False and not dist.is_initialized()
    assert bootstrap.init_process_group(allgather_fn=lambda p: [p], process_id=0) is None
    assert not dist.is_initialized()
    part = partitioner.active_partitioner()
    assert (part.process_index, part.process_count, part.is_multiprocess) == (0, 1, False)


def test_an_initialised_default_group_is_adopted_and_reset_tears_it_down(no_rank_env, monkeypatch):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=30))
    # adopted as it is: the environment of another group is not read
    monkeypatch.setenv("SRML_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SRML_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("SRML_TPU_PROCESS_ID", "3")
    assert bootstrap.init_from_env(device="cpu") is False  # a group of one rank
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert not partitioner.active_partitioner().is_multiprocess
    bootstrap.reset_process_group()
    assert not dist.is_initialized()
    bootstrap.reset_process_group()  # a second reset is harmless


@pytest.mark.parametrize("kind,world,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cpu", 4, 8, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 2, 2, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 5, 4, "gloo"), ("cuda", 1, 1, "nccl"),
])
def test_the_backend_rule(kind, world, cards, backend):
    assert bootstrap.backend_for(kind, world, cards) == backend


def test_each_rank_drives_card_rank_modulo_cards():
    assert [bootstrap.device_for_rank(r, "cuda", 2) for r in range(4)] == [
        torch.device("cuda", i) for i in (0, 1, 0, 1)]
    assert bootstrap.device_for_rank(3, "cpu", 0) == torch.device("cpu")


def test_a_rank_outside_the_group_and_a_missing_card_raise(no_rank_env):
    with pytest.raises(ValueError, match="process_id"):
        bootstrap.init_process_group("127.0.0.1:1", 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            bootstrap.init_process_group("127.0.0.1:1", 2, 0, device="cuda")
    assert not dist.is_initialized()


def test_a_rendezvous_that_never_completes_raises(tmp_path):
    """Rank 1 of 2 waits for a rank 0 that never comes: the group's timeout
    ends the wait with an error, and no single-process fit follows."""
    code = (
        "import datetime\n"
        "from spark_rapids_ml_torch.parallel import bootstrap\n"
        f"bootstrap.init_process_group('127.0.0.1:{_free_port()}', 2, 1, device='cpu',\n"
        "                              timeout=datetime.timedelta(seconds=3))\n"
        "print('GROUP UP')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "GROUP UP" not in res.stdout, res.stdout + res.stderr


def test_the_active_partitioner_is_one_rank_without_a_group(no_rank_env):
    part = partitioner.active_partitioner()
    assert isinstance(part, partitioner.Partitioner)
    assert (part.process_index, part.process_count, part.is_multiprocess) == (0, 1, False)


class _SharedCard(partitioner.Partitioner):
    """Rank `index` of `count` ranks, with `cards` cards on the host."""

    def __init__(self, index, count):
        self._index, self._count = index, count

    @property
    def process_index(self):
        return self._index

    @property
    def process_count(self):
        return self._count


@pytest.mark.parametrize("index,count,cards,share", [
    (0, 1, 1, 1), (0, 2, 1, 2), (1, 2, 1, 2), (0, 2, 2, 1), (1, 3, 2, 1), (0, 3, 2, 2), (2, 4, 4, 1),
])
def test_ranks_sharing_a_card_split_its_auto_stream_threshold(monkeypatch, index, count, cards, share):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(total_memory=80 << 30))
    part = _SharedCard(index, count)
    assert part.ranks_on_device() == share
    monkeypatch.setattr(partitioner, "active_partitioner", lambda: part)
    assert config.stream_threshold_bytes(torch.device("cuda")) == (40 << 30) // share


@pytest.mark.parametrize("count,want", [(1, 1 << 20), (2, 1 << 19), (3, (1 << 20) // 3)])
def test_each_rank_streams_its_share_of_a_global_batch(count, want):
    assert partitioner.resolve_batch_rows_per_process(_SharedCard(0, count)) == want
    config.set("stream_batch_rows", 2)
    try:
        assert partitioner.resolve_batch_rows_per_process(_SharedCard(0, 3)) == 1
    finally:
        config.unset("stream_batch_rows")
