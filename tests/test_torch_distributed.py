"""The port's sharded runtime and sharded session against the JAX package's
on an 8-device mesh.

The JAX side runs once per module, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the device count
locks at the first JAX init, so the test process keeps its one device):
every ``run_distributed`` case of ``tests/test_distributed.py``, then
8-shard sessions with ``tests/test_sharded_session.py``'s recipe (rmat(10,
avg_degree=6, seed=3), ``random_batch(…, 2e-3, seed=900+i)``) for the
three partitioners and the ``delta`` and ``bf16`` exchanges, 5 batches
each; then ``tests/test_fault_domains.py``'s two shard scenarios: the
helping one (8 shards, shard 3 lost at sweep 2 of batch 3, a stall of
shard 2, a stale ``ShardFault(7)``) and the elastic rescale (a durable
4-shard session on the 8-device mesh, checkpoint every 3 batches,
restored onto 2 shards and onto one device).  It writes its inputs, ranks
and counters to an ``.npz`` and keeps the rescale's store.  The port runs
the same calls in process on the CPU over logical shards, fed the
subprocess's own graphs, batches and start vectors, and restores the
subprocess's store as well as its own.

Gates: ``DistStats`` and the sessions' counters EQUAL (the recovery
events' too, but for their wall times); f64 ranks within 1e-12 of JAX's
(the same arithmetic, summed by tile here and by edge there) and, in the
fault scenarios, within the reference's 1e-9 of the port's blocked oracle; under ``bf16`` (f32, τ = 1e-7) within the JAX test's 1e-4 of the
oracle and of JAX's ranks; relabelings array-equal, ``edge_cut`` within
1e-12, ``collective_bytes_per_sweep`` equal.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api.config import EngineConfig
from repro_torch.api.session import PageRankSession
from repro_torch.core.fault_domain import ShardFault
from repro_torch.core import distributed as tdist
from repro_torch.core.graph import HostGraph
from repro_torch.core.integrity import IntegrityConfig

ROOT = Path(__file__).resolve().parents[1]

# run_distributed cases of tests/test_distributed.py (name -> kwargs; the
# dtypes by name, mapped on each side)
RT_CASES = {
    "full": dict(exchange="full"),
    "delta": dict(exchange="delta", delta_capacity=4096),
    "bf16": dict(exchange="bf16", tau=1e-7, dtype="float32"),
    "delta_int8": dict(exchange="delta", delta_capacity=4096,
                       marks_dtype="int8"),
    "gs3": dict(exchange="full", local_gs_sweeps=3),
    "ring": dict(exchange="ring"),
}
# 8-shard session streams (name -> EngineConfig kwargs)
SESSIONS = {
    "contiguous": dict(partitioner="contiguous"),
    "hash": dict(partitioner="hash"),
    "bfs_blocks": dict(partitioner="bfs_blocks"),
    "delta": dict(partitioner="contiguous", exchange="delta"),
    "bf16": dict(partitioner="hash", exchange="bf16", dtype="float32",
                 tau=1e-7),
}
N_BATCHES = 5
STAT_FIELDS = ("sweeps", "converged", "full_exchanges", "delta_exchanges",
               "edges_processed")
# tests/test_fault_domains.py's helping scenario: (batch, shard, at_sweep,
# permanent) of each injected fault; a stale ShardFault(7) joins the
# schedule before the extra batch (seed 990)
HELP_FAULTS = [(2, 3, 2, True), (5, 2, 1, False)]
N_HELP = 6
N_RESCALE = 4

SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np, jax.numpy as jnp
    from repro.api import EngineConfig, PageRankSession
    from repro.core import numpy_reference
    from repro.core.delta import random_batch
    from repro.core.distributed import (collective_bytes_per_sweep,
                                        run_distributed)
    from repro.core.frontier import batch_to_device, initial_affected
    from repro.graphs.generators import rmat

    assert len(jax.devices()) == 8
    (out_path, store_dir, rt_cases, sessions, n_batches, fields, help_faults,
     help_n, rescale_n) = json.loads(sys.argv[1])
    out = {}
    dt = lambda kw: {k: (getattr(jnp, v) if k in ("dtype", "marks_dtype")
                         else v) for k, v in kw.items()}

    # -- the runtime: tests/test_distributed.py's cases --------------------
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    hg0 = rmat(10, avg_degree=8, seed=3)
    g0 = hg0.snapshot(block_size=64)
    ref0 = numpy_reference(g0, iterations=300)
    dels, ins = random_batch(hg0, 1e-3, seed=11)
    hg1 = hg0.apply_batch(dels, ins)
    g1 = hg1.snapshot(block_size=64)
    out["rt_edges1"] = hg1.edges
    out["rt_ref1"] = numpy_reference(g1, iterations=300)
    aff0 = initial_affected(g0, g1, batch_to_device(g1, dels, ins))
    out["rt_r_prev"], out["rt_aff0"] = ref0, np.asarray(aff0)
    rp = jnp.asarray(ref0)
    for name, kw in rt_cases.items():
        R, st = run_distributed(hg1, mesh, r_prev=rp, affected0=aff0,
                                expand=True, **dt(kw))
        out[f"rt/{name}/R"] = np.asarray(R)
        out[f"rt/{name}/stats"] = [int(getattr(st, f)) for f in fields]
    R, st = run_distributed(hg1, mesh, expand=False)
    out["rt/static/R"] = np.asarray(R)
    out["rt/static/stats"] = [int(getattr(st, f)) for f in fields]

    # -- 8-shard sessions: tests/test_sharded_session.py's recipe ----------
    hg0 = rmat(10, avg_degree=6, seed=3)
    out["s_edges0"] = hg0.edges
    cur = hg0
    for i in range(n_batches):
        d, a = random_batch(cur, 2e-3, seed=900 + i)
        out[f"s_batch/{i}/dels"], out[f"s_batch/{i}/ins"] = d, a
        cur = cur.apply_batch(d, a)
    for name, kw in sessions.items():
        cfg = EngineConfig(topology="sharded", n_shards=8, **dt(kw))
        s = PageRankSession.from_graph(hg0, config=cfg)
        out[f"s/{name}/order"], out[f"s/{name}/inv"] = s._order, s._inv
        out[f"s/{name}/open"] = s.ranks
        s.warmup()
        rows = []
        for i in range(n_batches):
            res = s.update(out[f"s_batch/{i}/dels"], out[f"s_batch/{i}/ins"])
            out[f"s/{name}/ranks/{i}"] = s.ranks
            rows.append([res.stats.sweeps, res.stats.edges_processed,
                         int(res.stats.converged)])
        out[f"s/{name}/stats"] = rows
        replay = s.recompute("df")
        out[f"s/{name}/replay"] = s.ranks
        out[f"s/{name}/replay_stats"] = [replay.stats.sweeps,
                                         replay.stats.edges_processed]
        rep = s.report()
        out[f"s/{name}/report"] = [rep.edge_cut,
                                   rep.collective_bytes_per_sweep,
                                   rep.retraces_post_warmup,
                                   rep.total_sweeps,
                                   rep.total_edges_processed]
        out[f"s/{name}/exchanges"] = [s._x_full, s._x_delta, s._x_sweeps]
    # -- tests/test_fault_domains.py: shard helping ------------------------
    from repro.api import ShardFault
    def row(res, s):
        return [res.stats.sweeps, res.stats.edges_processed,
                int(res.stats.converged), s.report().n_shards or 0,
                res.driver_retraces, s._x_full, s._x_delta]
    r0 = numpy_reference(hg0.snapshot(block_size=64), iterations=300)
    out["h_r0"] = r0
    cur = hg0
    for i in range(help_n + 1):
        d, a = random_batch(cur, 2e-3, seed=(900 + i if i < help_n else 990))
        out[f"h_batch/{i}/dels"], out[f"h_batch/{i}/ins"] = d, a
        cur = cur.apply_batch(d, a)
    s = PageRankSession.from_graph(
        hg0, config=EngineConfig(topology="sharded", n_shards=8), r0=r0)
    s.warmup()
    rows = []
    for i in range(help_n + 1):
        for b, shard, at, perm in help_faults:
            if b == i:
                s.inject_shard_fault(shard, at_sweep=at, permanent=perm)
        if i == help_n:
            s._shard_faults._pending.append(ShardFault(7, permanent=True))
        res = s.update(out[f"h_batch/{i}/dels"], out[f"h_batch/{i}/ins"])
        out[f"h/ranks/{i}"] = s.ranks
        rows.append(row(res, s))
    out["h/stats"] = rows
    rep = s.report()
    out["h/events"] = json.dumps([{k: v for k, v in e.items()
                                   if k != "wall_time_s"}
                                  for e in rep.recovery_events])
    out["h/footprint"] = list(s.device_footprint)
    out["h/report"] = [rep.edge_cut, rep.collective_bytes_per_sweep,
                       rep.total_sweeps, rep.total_edges_processed]

    # -- verify -> the loss of shard 3 -> verify, with integrity= -----------
    from repro.core.integrity import IntegrityConfig
    s = PageRankSession.from_graph(
        hg0, config=EngineConfig(topology="sharded", n_shards=8,
                                 integrity=IntegrityConfig()), r0=r0)
    v = s.verify()
    out["i/first"] = [int(v.ok), v.checks_run]
    s.inject_shard_fault(3, at_sweep=2, permanent=True)
    s.update(out["h_batch/0/dels"], out["h_batch/0/ins"])
    out["i/n_pad"] = [s.n_pad, int(s._r_verified.shape[0])]
    outs = []
    for repair in (False, True):
        try:
            v = s.verify(repair=repair)
            outs.append(["ok", int(v.ok), [f["check"] for f in v.failures]])
        except Exception as e:
            outs.append([type(e).__name__, str(e)])
    out["i/outcomes"] = json.dumps(outs)

    # -- tests/test_fault_domains.py: the elastic rescale -------------------
    hg9 = rmat(9, avg_degree=6, seed=3)
    r9 = numpy_reference(hg9.snapshot(block_size=64), iterations=300)
    out["e_edges0"], out["e_r0"] = hg9.edges, r9
    cur = hg9
    for i in range(rescale_n):
        d, a = random_batch(cur, 2e-3, seed=700 + i)
        out[f"e_batch/{i}/dels"], out[f"e_batch/{i}/ins"] = d, a
        cur = cur.apply_batch(d, a)
    cfg4 = EngineConfig(topology="sharded", n_shards=4, durability="wal",
                        checkpoint_interval=3)
    s = PageRankSession.from_graph(hg9, config=cfg4, r0=r9,
                                   store_dir=store_dir)
    rows = []
    for i in range(rescale_n):
        res = s.update(out[f"e_batch/{i}/dels"], out[f"e_batch/{i}/ins"])
        out[f"e/ranks/{i}"] = s.ranks
        rows.append(row(res, s))
    out["e/stats"] = rows
    del s                                       # crash-stop
    for name, cfg in (("2", cfg4.replace(n_shards=2)),
                      ("1", EngineConfig(engine="blocked", block_size=64))):
        rest = PageRankSession.restore(store_dir, config=cfg)
        rep = rest.report()
        out[f"e/restore/{name}"] = rest.ranks
        out[f"e/restore/{name}/report"] = [rep.replayed_batches,
                                           rep.n_shards or 0,
                                           rep.total_sweeps,
                                           rep.total_edges_processed]
        rest.close()

    for ex in ("full", "bf16", "delta"):
        for ff in (1.0, 0.25):
            out[f"wire/{ex}/{ff}"] = collective_bytes_per_sweep(
                n_pad=1024, n_dev=8, exchange=ex, rank_bytes=8,
                delta_capacity=1024, frac_full=ff)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    print("JAX-OK")
""")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's runtime and sessions on an 8-device mesh, run once
    in a subprocess; its ``.npz`` loaded."""
    path = tmp_path_factory.mktemp("jax8") / "jax8.npz"
    store = path.parent / "rescale_store"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(ROOT / "src")
    arg = json.dumps([str(path), str(store), RT_CASES, SESSIONS, N_BATCHES,
                      STAT_FIELDS, HELP_FAULTS, N_HELP, N_RESCALE])
    out = subprocess.run([sys.executable, "-c", SCRIPT, arg], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-OK" in out.stdout
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["store"] = str(store)
    return out


def _torch_kw(kw: dict) -> dict:
    return {k: (getattr(torch, v) if k in ("dtype", "marks_dtype") else v)
            for k, v in kw.items()}


def _stats(st) -> list:
    return [int(getattr(st, f)) for f in STAT_FIELDS]


MESH = tdist.ShardMesh.on("cpu", 8)


@pytest.mark.parametrize("name", sorted(RT_CASES) + ["static"])
def test_run_distributed_matches_jax(jax_run, name):
    z = jax_run
    hg1 = HostGraph(1024, z["rt_edges1"])
    ref1 = z["rt_ref1"][:hg1.n]
    if name == "static":
        R, st = tdist.run_distributed(hg1, MESH, expand=False)
    else:
        R, st = tdist.run_distributed(
            hg1, MESH, r_prev=torch.from_numpy(z["rt_r_prev"]),
            affected0=torch.from_numpy(z["rt_aff0"]), expand=True,
            **_torch_kw(RT_CASES[name]))
    R = R.numpy()[:hg1.n]
    jR = z[f"rt/{name}/R"][:hg1.n]
    assert st.converged
    if name == "bf16":
        assert R.dtype == np.float32
        assert np.abs(R - ref1).max() < 1e-4
        assert np.abs(R - jR).max() < 1e-4
    else:
        assert np.abs(R - jR).max() <= 1e-12
        assert np.abs(R - ref1).max() < 1e-8
    assert _stats(st) == list(z[f"rt/{name}/stats"]), name
    if name.startswith("delta"):
        assert st.delta_exchanges > 0


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_sharded_session_stream_matches_jax(jax_run, name):
    z = jax_run
    kw = _torch_kw(SESSIONS[name])
    tol = 1e-4 if name == "bf16" else 1e-12
    hg0 = HostGraph(1024, z["s_edges0"])
    sess = PageRankSession.from_graph(
        hg0, config=EngineConfig(topology="sharded", n_shards=8, **kw),
        device="cpu")
    np.testing.assert_array_equal(sess._order, z[f"s/{name}/order"])
    np.testing.assert_array_equal(sess._inv, z[f"s/{name}/inv"])
    assert np.abs(sess.ranks - z[f"s/{name}/open"]).max() <= tol
    sess.warmup()
    for i in range(N_BATCHES):
        res = sess.update(z[f"s_batch/{i}/dels"], z[f"s_batch/{i}/ins"])
        assert np.abs(sess.ranks - z[f"s/{name}/ranks/{i}"]).max() <= tol
        assert [res.stats.sweeps, res.stats.edges_processed,
                int(res.stats.converged)] == list(z[f"s/{name}/stats"][i])
    replay = sess.recompute("df")
    assert np.array_equal(replay.ranks.numpy(), res.ranks.numpy())
    assert [replay.stats.sweeps, replay.stats.edges_processed] == \
        list(z[f"s/{name}/replay_stats"])
    rep = sess.report()
    j_cut, j_wire, j_retr, j_sw, j_edges = z[f"s/{name}/report"]
    assert abs(rep.edge_cut - j_cut) <= 1e-12
    assert rep.collective_bytes_per_sweep == j_wire
    assert rep.retraces_post_warmup == j_retr == 0
    assert (rep.total_sweeps, rep.total_edges_processed) == (j_sw, j_edges)
    assert [sess._x_full, sess._x_delta, sess._x_sweeps] == \
        list(z[f"s/{name}/exchanges"])
    assert rep.topology == "sharded" and rep.n_shards == 8
    assert rep.partitioner == SESSIONS[name]["partitioner"]


@pytest.mark.parametrize("exchange", ["full", "bf16", "delta"])
@pytest.mark.parametrize("frac_full", [1.0, 0.25])
def test_collective_bytes_per_sweep_matches_jax(jax_run, exchange,
                                                frac_full):
    got = tdist.collective_bytes_per_sweep(
        n_pad=1024, n_dev=8, exchange=exchange, rank_bytes=8,
        delta_capacity=1024, frac_full=frac_full)
    assert got == jax_run[f"wire/{exchange}/{frac_full}"]


# ---------------------------------------------------------------------------
# the shard fault domain: tests/test_fault_domains.py's 8-device scenarios
# ---------------------------------------------------------------------------

def _fault_row(res, sess) -> list:
    """The subprocess's row but for ``driver_retraces`` (the JAX session
    compiles its sweep anew for the shrunken mesh; the port builds
    nothing)."""
    return [res.stats.sweeps, res.stats.edges_processed,
            int(res.stats.converged), sess.report().n_shards or 0,
            sess._x_full, sess._x_delta]


def _jax_row(row) -> list:
    row = [int(x) for x in row]
    return row[:4] + row[5:]


def _oracle(hg, r0):
    return PageRankSession.from_graph(
        hg, config=EngineConfig(engine="blocked"), r0=r0, device="cpu")


def test_shard_crash_helping_matches_jax(jax_run):
    """The helping scenario: shard 3 of 8 lost after 2 sweeps of batch 3
    (helped, then re-partitioned onto 7 shards), a stall of shard 2 on
    batch 6 (no shrink), a stale ``ShardFault(7)`` dropped on batch 7."""
    z = jax_run
    hg0 = HostGraph(1024, z["s_edges0"])
    oracle = _oracle(hg0, z["h_r0"])
    sess = PageRankSession.from_graph(
        hg0, config=EngineConfig(topology="sharded", n_shards=8),
        r0=z["h_r0"], device="cpu")
    sess.warmup()
    shards = []
    for i in range(N_HELP + 1):
        for b, shard, at, perm in HELP_FAULTS:
            if b == i:
                sess.inject_shard_fault(shard, at_sweep=at, permanent=perm)
        if i == N_HELP:
            sess._shard_faults._pending.append(ShardFault(7, permanent=True))
        d, a = z[f"h_batch/{i}/dels"], z[f"h_batch/{i}/ins"]
        res = sess.update(d, a)
        assert oracle.update(d, a).stats.converged
        assert res.driver_retraces == 0
        assert _fault_row(res, sess) == _jax_row(z["h/stats"][i]), i
        assert np.abs(sess.ranks - z[f"h/ranks/{i}"]).max() <= 1e-12, i
        assert np.abs(sess.ranks[:sess.n]
                      - oracle.ranks[:oracle.n]).max() <= 1e-9, i
        shards.append(sess.report().n_shards)
    assert shards == [8, 8, 7, 7, 7, 7, 7]
    rep = sess.report()
    events = json.loads(json.dumps([
        {k: v for k, v in e.items() if k != "wall_time_s"}
        for e in rep.recovery_events]))
    assert events == json.loads(str(z["h/events"]))
    assert [e["permanent"] for e in events] == [True, False]
    assert events[0]["shard"] == 3 and events[0]["helped_vertices"] > 0
    assert events[0]["recovery_sweeps"] > 0
    assert all(e["wall_time_s"] > 0 for e in rep.recovery_events)
    j_cut, j_wire, j_sw, j_edges = z["h/report"]
    assert abs(rep.edge_cut - j_cut) <= 1e-12
    assert rep.collective_bytes_per_sweep == j_wire
    assert (rep.total_sweeps, rep.total_edges_processed) == (j_sw, j_edges)
    assert rep.retraces_post_warmup == 0
    # the reference's mesh loses device 3; the port's logical shards all
    # sit on the one device (ROADMAP watch list 1)
    assert list(z["h/footprint"]) == [0, 1, 2, 4, 5, 6, 7]
    assert sess.device_footprint == (0,)


def test_verify_after_shard_loss_matches_jax(jax_run):
    """verify → the loss of shard 3 of 8 → verify on an ``integrity=``
    session: the shrink pads the ranks anew but leaves the drift baseline
    at the old length, so the second verify raises ``TypeError`` in both
    packages, repairing or not (ROADMAP watch list 1)."""
    z = jax_run
    sess = PageRankSession.from_graph(
        HostGraph(1024, z["s_edges0"]),
        config=EngineConfig(topology="sharded", n_shards=8,
                            integrity=IntegrityConfig()),
        r0=z["h_r0"], device="cpu")
    v = sess.verify()
    assert [int(v.ok), v.checks_run] == [int(x) for x in z["i/first"]]
    sess.inject_shard_fault(3, at_sweep=2, permanent=True)
    sess.update(z["h_batch/0/dels"], z["h_batch/0/ins"])
    assert [sess.n_pad, int(sess._r_verified.shape[0])] == \
        [int(x) for x in z["i/n_pad"]]
    assert sess.n_pad != sess._r_verified.shape[0]
    for repair, (j_type, j_msg) in zip(
            (False, True), json.loads(str(z["i/outcomes"]))):
        with pytest.raises(Exception) as e:
            sess.verify(repair=repair)
        assert type(e.value).__name__ == j_type == "TypeError", repair
        shapes = (f"incompatible shapes for broadcasting: ({sess.n_pad},), "
                  f"({sess._r_verified.shape[0]},)")
        assert shapes in str(e.value) and shapes in j_msg, repair


def test_restore_elastic_rescale_matches_jax(jax_run, tmp_path):
    """The elastic rescale: a durable 4-shard session (checkpoint at batch
    3, one WAL record after it) crash-stops; its store, and the JAX
    package's, restore onto 2 shards and onto one device with one batch
    replayed, the restores' counters equal to the JAX package's."""
    z = jax_run
    hg9 = HostGraph(512, z["e_edges0"])
    oracle = _oracle(hg9, z["e_r0"])
    cfg4 = EngineConfig(topology="sharded", n_shards=4, durability="wal",
                        checkpoint_interval=3)
    store = str(tmp_path / "t")
    sess = PageRankSession.from_graph(hg9, config=cfg4, r0=z["e_r0"],
                                      device="cpu", store_dir=store)
    for i in range(N_RESCALE):
        d, a = z[f"e_batch/{i}/dels"], z[f"e_batch/{i}/ins"]
        res = sess.update(d, a)
        assert oracle.update(d, a).stats.converged
        assert _fault_row(res, sess) == _jax_row(z["e/stats"][i]), i
        assert np.abs(sess.ranks - z[f"e/ranks/{i}"]).max() <= 1e-12, i
    ref = oracle.ranks[:oracle.n]
    assert sess.store.latest_checkpoint_index == 3
    del sess                                    # crash-stop: no close()
    for src in (store, z["store"]):
        for name, cfg in (("2", cfg4.replace(n_shards=2)),
                          ("1", EngineConfig(engine="blocked",
                                             block_size=64))):
            rest = PageRankSession.restore(src, config=cfg, device="cpu")
            rep = rest.report()
            assert [rep.replayed_batches, rep.n_shards or 0,
                    rep.total_sweeps, rep.total_edges_processed] == \
                [int(x) for x in z[f"e/restore/{name}/report"]], (src, name)
            assert rep.replayed_batches == 1
            r = rest.ranks[:rest.n]
            assert np.abs(r - z[f"e/restore/{name}"][:rest.n]).max() \
                <= 1e-12, (src, name)
            assert np.abs(r - ref).max() <= 1e-9, (src, name)
            rest.close()
