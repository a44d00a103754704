"""The port's runtime entry (``beholder_tpu_torch/parallel/distributed.py``)
against the reference's ``beholder_tpu/parallel/distributed.py``.

The reference runs over the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh over ``devices=["cpu"] * 8``. Shapes, axis names and error
messages are compared exactly. The process group tests run one ``gloo``
process on a free local port and tear it down; the mesh over two processes
is held against the reference in ``tests/test_torch_multiprocess.py``.
"""

import socket

import jax
import pytest
import torch
import torch.distributed as dist

from beholder_tpu.parallel import make_hybrid_mesh as ref_make_hybrid_mesh
from beholder_tpu_torch.parallel import distributed, initialize, make_hybrid_mesh

CPUS = ["cpu"] * 8


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture
def captured(monkeypatch):
    """``init_process_group``'s arguments, instead of a group."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_initialize_is_noop_without_coordinator(monkeypatch, captured):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    initialize()  # neither joins a group nor asks for a card
    assert captured == []


@pytest.mark.parametrize("ici_tp", [1, 2, 4, 8])
def test_hybrid_mesh_single_process_shape(ici_tp):
    mesh = make_hybrid_mesh(ici_tp=ici_tp, devices=CPUS)
    ref = ref_make_hybrid_mesh(ici_tp=ici_tp)
    assert len(jax.devices()) == len(CPUS)
    assert mesh.axis_names == tuple(ref.axis_names) == ("dp", "tp")
    assert mesh.grid.shape == ref.devices.shape == (8 // ici_tp, ici_tp)
    assert mesh.shape == {"dp": 8 // ici_tp, "tp": ici_tp}
    assert mesh.devices == tuple(torch.device("cpu") for _ in CPUS)


@pytest.mark.parametrize("ici_tp", [3, 5, 16])
def test_hybrid_mesh_validates_divisibility(ici_tp):
    with pytest.raises(ValueError, match="does not divide") as port_err:
        make_hybrid_mesh(ici_tp=ici_tp, devices=CPUS)
    with pytest.raises(ValueError) as ref_err:
        ref_make_hybrid_mesh(ici_tp=ici_tp)
    assert str(port_err.value) == str(ref_err.value)


def test_hybrid_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hybrid_mesh(ici_tp=1)


def test_explicit_process_id_zero_beats_a_stale_rank(monkeypatch, captured):
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    initialize("10.0.0.1:1234", num_processes=1, process_id=0, device="cpu")
    assert captured == [dict(backend="gloo", init_method="tcp://10.0.0.1:1234",
                             world_size=1, rank=0)]


def test_launcher_variables_fill_what_is_omitted(monkeypatch, captured):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "4321")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    initialize(device="cpu", timeout_s=5)
    (kw,) = captured
    assert kw["init_method"] == "tcp://10.0.0.2:4321"
    assert (kw["world_size"], kw["rank"], kw["backend"]) == (4, 3, "gloo")
    assert kw["timeout"].total_seconds() == 5
    monkeypatch.delenv("MASTER_PORT")
    initialize("10.0.0.3", device="cpu")
    assert captured[-1]["init_method"] == f"tcp://10.0.0.3:{distributed.DEFAULT_PORT}"
    # the card by default: no card, no group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize()
    assert len(captured) == 2


def test_one_process_gloo_group():
    assert not dist.is_initialized()
    initialize(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0, device="cpu",
               timeout_s=30)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert dist.get_rank() == 0
        x = torch.arange(64, dtype=torch.float32) * 0.5 - 7.25
        y = x.clone()
        dist.all_reduce(y)
        assert torch.equal(y, x)
        assert distributed.process_count() == 1
        mesh = make_hybrid_mesh(ici_tp=2, devices=CPUS)
        assert mesh.grid.shape == (4, 2)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
