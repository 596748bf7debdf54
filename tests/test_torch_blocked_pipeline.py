"""The hazard rule of the blocked sweep kernel's lookahead pipeline, on the
CPU.

``kernels/blocked_sweep/csrc/blocked_sweep.cu`` stages slot *a* while only
slots ``<= c`` are done (``c >= a − D − 1`` for a ring of D items): a read of
``R[s]`` is final unless ``c < pos[s / B] < a`` (then it is resolved at
consume time from a window of the last ``D + 1`` slots' block ranks), and
``affected`` is the value staged after slot ``c`` OR the marks that slots
``c+1 .. a−1`` recorded for slot *a* in a per-window bitmap.  A slot whose
in- or out-edges exceed the ring's E edges streams through it in chunks,
each vertex carrying its running sum, partial and tile boundary.

:func:`lookahead_sweep` emulates that in numpy: each slot is staged against
the state after slot ``c`` (the stalest the ring allows, or a seeded lag),
its producer folding each vertex up to its first pending read, then the
consumer resumes those folds, writes and expands in slot order.  It must equal
``blocked_sweep_plain`` bit for bit (ranks and ``maxdr`` exactly, ``affected``,
``RC`` with its trash entry and the per-slot edges array-equal) in LF and
BB, f32 and f64, with and without expansion, D ∈ {1, 2, 8}; and through it
``src/repro/core/blocked.py::sweep``: in f64 affected, RC and edges
array-equal and ranks within 1e-12, in f32 ranks within 2e-5 (the
reference's ``segment_sum`` orders its sums otherwise, as
``tests/test_torch_blocked.py`` states; in f32 that moves a few changes
across τ, so RC and the marks may differ there).  Two controls show the test can fail: without the hazard rule
(stale reads) or without the window's marks the emulation parts from the
plain version.
"""
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import blocked as jblk
from repro.core.graph import HostGraph as JHostGraph
from repro.graphs import generators as jgen
from repro_torch.core import blocked as tblk
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.kernels.blocked_sweep import blocked_sweep as bws

TAU = {np.float64: 1e-10, np.float32: 1e-7}
RANK_TOL = {np.float64: 1e-12, np.float32: 2e-5}
T_DT = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def lookahead_sweep(sg, R, read, affected, rc, slot_ids, slot_mask, *, n,
                    alpha, tau, tau_f, tile, expand, jacobi, D, E, lag,
                    hazard_rule=True, window_marks=True):
    """The kernel's pipeline in numpy, in place on ``R``/``affected``/``rc``
    (numpy arrays; ``read`` is ``R`` itself in LF).  ``lag(a)`` gives how
    many slots behind slot *a* its producer's view is (clamped to the
    ring's ``D``).  Returns ``(maxdr, edges, items)``; ``items`` counts the
    ring items, which exceed the active slots when a slot was chunked."""
    dt = R.dtype.type
    B, n_pad = sg.block, sg.n_pad
    nb = n_pad // B
    a_c, base_r, tau_c, tau_f_c = (dt(x) for x in bws._scalars(
        T_DT[dt], n, alpha, tau, tau_f))
    src, osrc, odst = (sg.src.numpy(), sg.osrc.numpy(), sg.odst.numpy())
    vptr, ibp = sg.vptr.numpy(), sg.in_block_ptr.numpy()
    in_lo, in_len = sg.in_lo.numpy(), sg.in_len.numpy()
    out_lo, out_len = sg.out_lo.numpy(), sg.out_len.numpy()
    inv, valid = sg.inv_deg.numpy(), sg.valid.numpy()
    lf = not jacobi

    # prologue: the active slots, pos (the first of a block named twice)
    K = len(slot_ids)
    edges = np.zeros(K, np.int32)
    act = [(k, int(slot_ids[k])) for k in range(K)
           if slot_mask[k] and slot_ids[k] >= 0]
    pos = np.full(nb, -1, np.int64)
    dup = False
    for a, (_, b) in enumerate(act):
        if pos[b] != -1:
            dup = True
        else:
            pos[b] = a
    W = D + 1
    win = np.zeros((W, B), dt)
    marks = np.zeros((W, B), bool)

    def stage(a, c):
        k, b = act[a]
        base = b * B
        lo, ilen, olo, olen = (int(in_lo[b]), int(in_len[b]),
                               int(out_lo[b]), int(out_len[b]))
        s = src[lo:lo + ilen].astype(np.int64)
        sc = np.minimum(s, n_pad - 1)
        q = pos[sc // B] if lf else np.full(ilen, -1)
        pending = (c < q) & (q < a) if hazard_rule else np.zeros(ilen, bool)
        val = np.where(pending, inv[s], read[sc] * inv[s]).astype(dt)
        # the producer's fold of each vertex up to its first pending read
        # (a slot of one chunk; the consumer resumes there)
        r0 = vptr[base:base + B + 1].astype(np.int64) - ibp[b]
        rpos, bnd = r0[:-1].copy(), (r0[:-1] // tile + 1) * tile
        acc, part = np.zeros(B, dt), np.zeros(B, dt)
        if ilen <= E:
            for l in range(B):
                r = rpos[l]
                while r < r0[l + 1] and not pending[r]:
                    if r == bnd[l]:
                        acc[l] = acc[l] + part[l]
                        part[l] = dt(0)
                        bnd[l] += tile
                    part[l] = part[l] + val[r]
                    r += 1
                rpos[l] = r
        w = odst[olo:olo + olen].astype(np.int64)
        p = np.where(w < n_pad, pos[np.minimum(w, n_pad - 1) // B], -1)
        mark = (~np.bool_(dup)) & (p > a) & (p <= a + D)
        return dict(
            k=k, base=base, ilen=ilen, olen=olen,
            r0=r0, rpos=rpos, bnd=bnd, acc=acc, part=part,
            aff=affected[base:base + B].copy(), valid=valid[base:base + B],
            old=R[base:base + B].copy(), val=val, pend=pending,
            pslot=q % W, plane=sc % B,
            lane=np.clip(osrc[olo:olo + olen].astype(np.int64) - base, 0,
                         B - 1), w=w, mark=mark, mslot=p % W, mlane=w % B)

    def consume(a, st):
        nonlocal maxdr, items
        base, ilen, olen = st["base"], st["ilen"], st["olen"]
        wa = a % W
        upd = (st["aff"] | marks[wa]) & st["valid"]
        n_in = max(1, -(-ilen // E))
        n_out = -(-olen // E) if expand else 0
        items += n_in + max(n_out - 1, 0)
        r_at, r_end, bnd = st["rpos"].copy(), st["r0"][1:], st["bnd"].copy()
        acc, part = st["acc"].copy(), st["part"].copy()
        for t in range(n_in):                      # the in-chunks in order
            ce = min(ilen, (t + 1) * E)
            for l in np.nonzero(upd)[0]:
                for r in range(r_at[l], min(r_end[l], ce)):
                    if r == bnd[l]:
                        acc[l] = acc[l] + part[l]
                        part[l] = dt(0)
                        bnd[l] += tile
                    v = st["val"][r]
                    if st["pend"][r]:
                        v = win[st["pslot"][r], st["plane"][r]] * v
                    part[l] = part[l] + v
                r_at[l] = max(r_at[l], min(r_end[l], ce))
        changed = np.zeros(B, bool)
        fin = st["old"].copy()
        for l in np.nonzero(upd)[0]:
            acc[l] = acc[l] + part[l]
            r_new = base_r + a_c * acc[l]
            dr = abs(r_new - st["old"][l])
            R[base + l] = r_new
            rc[base + l] = dr > tau_c
            maxdr = max(maxdr, dr)
            changed[l] = dr > tau_f_c
            fin[l] = r_new
        win[wa] = fin
        ex = expand and bool(changed.any())
        if ex:
            trash = False
            for j in range(olen):
                if changed[st["lane"][j]]:
                    w = st["w"][j]
                    affected[w] = True
                    rc[w] = True
                    if window_marks and st["mark"][j]:
                        marks[st["mslot"][j], st["mlane"][j]] = True
                else:
                    trash = True
            if trash or olen % tile:
                affected[n_pad] = True
                rc[n_pad] = True
        edges[st["k"]] = ilen + (olen if ex else 0)
        marks[wa] = False

    # the schedule: slot a is staged when slots 0..c are done, c >= a-D-1
    due = {}
    for a in range(len(act)):
        c = a - 1 if dup else max(-1, a - 1 - min(D, lag(a)))
        due.setdefault(c + 1, []).append(a)
    maxdr, items = dt(0), 0
    staged = {}
    for done in range(len(act)):
        for a in due.get(done, ()):
            staged[a] = stage(a, done - 1)
        consume(done, staged.pop(done))
    return maxdr, edges, items


# ---------------------------------------------------------------------------
# graphs and inputs
# ---------------------------------------------------------------------------

def _chain(n=2048, seed=0):
    """Each vertex's in-edges come from its neighbours on a path and a few
    vertices up to two blocks away (B = 64): every block shares edges with
    the next and the previous, as a grid_road row does."""
    rng = np.random.default_rng(seed)
    i = np.arange(n - 1)
    far = rng.integers(0, n, (n // 4, 1)) + rng.integers(-128, 129,
                                                         (n // 4, 1))
    extra = np.concatenate([rng.integers(0, n, (n // 4, 1)), far], 1)
    edges = np.concatenate([np.stack([i, i + 1], 1), np.stack([i + 1, i], 1),
                            extra % n])
    return JHostGraph(n, edges)


GRAPHS = {
    "chain": _chain,
    # a hub whose block's in-edges exceed the ring's E = 64 edges
    "rmat": lambda: jgen.rmat(10, avg_degree=6, seed=2),
    # n = 500 on a 512-vertex grid: padding vertices in the last block
    "er500": lambda: jgen.erdos_renyi(500, avg_degree=6, seed=1),
}
RING_EDGES = 64


@functools.lru_cache(maxsize=None)
def _graph(name, block):
    jhg = GRAPHS[name]()
    thg = THostGraph(jhg.n, jhg.edges)
    return (jhg.snapshot(block_size=block),
            thg.snapshot(block_size=block, device="cpu"))


def _inputs(g, dt, seed, *, in_order=True, holes=True):
    """Ranks near the fixed point with per-block perturbations from 0 to
    1e-8, a random affected set, and a slot list in block order (so each
    slot reads the last one's block and marks the next) or permuted, with
    masked and −1 slots inside the window."""
    from repro_torch.core.pagerank import numpy_reference
    rng = np.random.default_rng(seed)
    n_pad, B, nb = g.n_pad, g.block_size, g.n_blocks
    lo, hi = (-15, -8) if dt == np.float64 else (-10, -4)
    scale = np.repeat(10.0 ** rng.uniform(lo, hi, nb), B)
    scale[np.repeat(rng.random(nb) < 0.25, B)] = 0.0
    R = (numpy_reference(g, iterations=300)
         + scale * rng.standard_normal(n_pad)).astype(dt)
    aff = np.r_[rng.random(n_pad) < 0.5, False]
    order = np.arange(nb) if in_order else rng.permutation(nb)
    ids = order.astype(np.int32)
    mask = np.ones(nb, bool)
    if holes and nb > 2:
        at = rng.choice(nb, size=max(1, nb // 6), replace=False)
        ids = np.insert(ids, np.sort(at), -1).astype(np.int32)
        mask = np.insert(mask, np.sort(at), True)
        mask[rng.choice(len(mask), size=max(1, nb // 8), replace=False)] = False
    return R, aff, ids, mask


def _sweep_graph(tg, dt):
    return tblk.sweep_graph(tg, T_DT[dt])


def _kw(dt, expand, tile, jacobi):
    tau = TAU[dt]
    return dict(alpha=0.85, tau=tau, tau_f=tau / 1000 if expand
                else float("inf"), tile=tile, expand=expand, jacobi=jacobi)


def _plain(tg, dt, R, aff, ids, mask, **kw):
    Rt = torch.from_numpy(R.copy())
    a = torch.from_numpy(aff.copy())
    c = a.clone()
    read = Rt.clone() if kw["jacobi"] else Rt
    m, e = bws.blocked_sweep_plain(_sweep_graph(tg, dt), Rt, read, a, c,
                                   torch.from_numpy(ids),
                                   torch.from_numpy(mask), n=tg.n, **kw)
    return Rt.numpy(), a.numpy(), c.numpy(), m.numpy()[0], e.numpy()


def _emulate(tg, dt, R, aff, ids, mask, *, D, E=RING_EDGES, lag=None,
             **kw):
    R, aff = R.copy(), aff.copy()
    rc = aff.copy()
    read = R.copy() if kw["jacobi"] else R
    lag = lag or (lambda a: D)
    m, e, items = lookahead_sweep(_sweep_graph(tg, dt), R, read, aff, rc,
                                  ids, mask, n=tg.n, D=D, E=E, lag=lag, **kw)
    return (R, aff, rc, m, e), items


def _assert_same(emu, plain):
    for x, y, what in zip(emu, plain, ("R", "affected", "RC", "maxdr",
                                       "edges")):
        np.testing.assert_array_equal(x, y, err_msg=what)


@functools.lru_cache(maxsize=None)
def _reference(name, dt, expand, jacobi, seed):
    """``src/repro/core/blocked.py::sweep`` on the same inputs."""
    jg, tg = _graph(name, 64)
    R, aff, ids, mask = _inputs(tg, dt, seed)
    kw = _kw(dt, expand, 512, jacobi)
    Rj = jnp.asarray(R)
    out = jblk.sweep(jg, Rj, jnp.asarray(aff), jnp.asarray(aff),
                     jnp.asarray(ids), jnp.asarray(mask), Rj,
                     jnp.asarray(0.85, dt), jnp.asarray(kw["tau"], dt),
                     jnp.asarray(kw["tau_f"], dt), tile=512, expand=expand,
                     jacobi=jacobi, dtype_name=np.dtype(dt).name)
    return [np.asarray(x) for x in out]


# ---------------------------------------------------------------------------
# the emulation against the plain version and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("dt", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["lf", "bb"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_lookahead_equals_plain_and_reference(graph, mode, dt, expand, D):
    """At the stalest view the ring allows (c = a − D − 1): bit for bit the
    plain version; the reference's affected, RC and edges array-equal and
    ranks within its tolerance."""
    jg, tg = _graph(graph, 64)
    seed = len(graph)
    R, aff, ids, mask = _inputs(tg, dt, seed)
    kw = _kw(dt, expand, 512, mode == "bb")
    emu, items = _emulate(tg, dt, R, aff, ids, mask, D=D, **kw)
    _assert_same(emu, _plain(tg, dt, R, aff, ids, mask, **kw))
    jR, jA, jC, jm, je = _reference(graph, dt, expand, mode == "bb", seed)
    if dt == np.float64:
        np.testing.assert_array_equal(emu[1], jA)
        np.testing.assert_array_equal(emu[2], jC)
        np.testing.assert_array_equal(emu[4], je)
    tol = RANK_TOL[dt]
    assert np.abs(emu[0].astype(np.float64) - jR).max() <= tol
    assert abs(float(emu[3]) - float(jm)) <= tol
    active = int(((ids >= 0) & mask).sum())
    assert items > active            # slots streamed through in chunks


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("graph", ["chain", "rmat"])
def test_lookahead_random_lags(graph, seed, D):
    """Each slot staged at a seeded lag between 0 and D slots, in a
    permuted slot list (sources in later slots' blocks): LF with expansion,
    bit for bit the plain version."""
    _, tg = _graph(graph, 64)
    R, aff, ids, mask = _inputs(tg, np.float64, 40 + seed, in_order=False)
    lags = np.random.default_rng(seed).integers(0, D + 1, len(ids))
    kw = _kw(np.float64, True, 64, False)
    emu, _ = _emulate(tg, np.float64, R, aff, ids, mask, D=D,
                      lag=lambda a: int(lags[a]), **kw)
    _assert_same(emu, _plain(tg, np.float64, R, aff, ids, mask, **kw))


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("block", [1, 64, 1024])
def test_lookahead_block_sizes(block, D):
    """B = 1 (a slot a vertex), 64 and 1024 (two blocks on the chain), LF
    with expansion and small chunks, bit for bit the plain version."""
    _, tg = _graph("chain", block)
    R, aff, ids, mask = _inputs(tg, np.float64, block + D)
    kw = _kw(np.float64, True, 64, False)
    emu, _ = _emulate(tg, np.float64, R, aff, ids, mask, D=D, E=32, **kw)
    _assert_same(emu, _plain(tg, np.float64, R, aff, ids, mask, **kw))


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("K", [0, 1, 3, 7])
def test_lookahead_short_slot_lists(K, D):
    """K ∈ {0, 1} and K < D: the window never fills."""
    _, tg = _graph("chain", 64)
    R, aff, ids, mask = _inputs(tg, np.float64, K, holes=False)
    ids, mask = ids[:K], mask[:K]
    kw = _kw(np.float64, True, 512, False)
    emu, items = _emulate(tg, np.float64, R, aff, ids, mask, D=D, **kw)
    _assert_same(emu, _plain(tg, np.float64, R, aff, ids, mask, **kw))
    assert items >= K


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("mode", ["lf", "bb"])
def test_lookahead_block_named_twice(mode, D):
    """A slot list that names blocks twice: lag 1 for every slot, exact."""
    _, tg = _graph("chain", 64)
    R, aff, ids, mask = _inputs(tg, np.float64, 5, holes=False)
    ids = np.concatenate([ids, ids[::3]]).astype(np.int32)
    mask = np.ones(len(ids), bool)
    kw = _kw(np.float64, True, 64, mode == "bb")
    emu, _ = _emulate(tg, np.float64, R, aff, ids, mask, D=D, **kw)
    _assert_same(emu, _plain(tg, np.float64, R, aff, ids, mask, **kw))


@pytest.mark.parametrize("what", ["hazard_rule", "window_marks"])
def test_lookahead_without_the_rule_differs(what):
    """The controls: on the chain (each slot reads the last slot's block and
    marks the next), staged two slots behind, dropping the pending reads
    or the window's marks parts from the plain version."""
    _, tg = _graph("chain", 64)
    R, aff, ids, mask = _inputs(tg, np.float64, 3, holes=False)
    kw = _kw(np.float64, True, 512, False)
    plain = _plain(tg, np.float64, R, aff, ids, mask, **kw)
    emu, _ = _emulate(tg, np.float64, R, aff, ids, mask, D=2, **kw)
    _assert_same(emu, plain)
    R2, aff2 = R.copy(), aff.copy()
    rc2 = aff2.copy()
    lookahead_sweep(_sweep_graph(tg, np.float64), R2, R2, aff2, rc2, ids,
                    mask, n=tg.n, D=2, E=RING_EDGES, lag=lambda a: 2,
                    **{what: False}, **kw)
    assert not (np.array_equal(R2, plain[0])
                and np.array_equal(aff2, plain[1])
                and np.array_equal(rc2, plain[2]))
