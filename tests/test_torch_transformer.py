"""The port's transformer layers (``repro_torch.models.transformer``) against
the JAX package's, and twins of the reference's transformer property tests,
in one process on the CPU.

- Each layer function on random inputs with the JAX params carried over
  (``rmsnorm``, ``apply_rope``, ``causal_attention_with_kv``,
  ``decode_attention``, ``dense_mlp``, ``moe_mlp``): f32 within rtol 1e-5
  and an atol of 1e-5 × the output's largest magnitude (a layer's output
  is a sum of terms of that scale; the worst gap measured is 3e-6 × it).
- The float8 KV cache: the cast's bytes equal ``jnp.astype`` 's, beyond
  ±464 too, where torch's own cast saturates and the reference's gives NaN;
  a prefill and a decode step with ``cache_dtype="float8_e4m3fn"`` whose
  K/V reach past the range store the reference's bytes; the twin of
  ``tests/test_models.py::test_f8_kv_cache_structural``.
- ``top_k``'s tie order (``lax.top_k``: the lower index first) and a MoE
  router with tied experts routed as the reference routes.
- Twins of ``tests/test_models.py:25-115`` (causality, GQA with kv == heads
  is MHA, chunking is exact, scan vs unrolled, vocab padding, MoE capacity)
  and ``tests/test_archs_smoke.py:50``, ``:83`` and ``:137`` (prefill/decode
  consistency, output shapes, Mixtral's sliding window) on the port, with
  params from the port's ``init_params``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.configs as jconfigs
from repro.models.transformer import layers as JL
from repro.models.transformer import model as JM
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.transformer import layers as TL
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-4          # f32 logits (tests/test_torch_lm_configs.py)
LAYER_TOL = 1e-5                 # layers: rtol, and atol × the output's max
LM_ARCHS = ("qwen1.5-4b", "phi4-mini-3.8b", "nemotron-4-340b",
            "granite-moe-3b-a800m", "mixtral-8x22b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _close_layer(got, want):
    """rtol 1e-5, atol 1e-5 × max |want|: a layer's output is a sum of
    terms of its own scale, so its rounding is relative to that scale."""
    w = _np(want)
    _close(got, want, rtol=LAYER_TOL,
           atol=LAYER_TOL * float(np.abs(w[np.isfinite(w)]).max()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _layer0(arch, **overrides):
    """(JAX cfg, port cfg, layer-0 params of each) at the smoke config."""
    jcfg = jconfigs.get_arch(arch).smoke_cfg()
    tcfg = tconfigs.get_arch(arch).smoke_cfg()
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              device=CPU)
    j0 = {k.split("/", 1)[1]: v[0] for k, v in jp.items()
          if k.startswith("layers/")}
    t0 = {k.split("/", 1)[1]: v[0] for k, v in tp.items()
          if k.startswith("layers/")}
    return jcfg, tcfg, j0, t0


def _tiny_cfg(**kw):
    """tests/test_models.py::_tiny_cfg."""
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, dtype="float32", param_dtype="float32",
                attn_q_chunk=16, remat=False)
    base.update(kw)
    return TransformerConfig(**base)


def _rand_tokens(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, shape))


# ---------------------------------------------------------------------------
# each layer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_layers_match_jax(arch):
    jcfg, tcfg, j0, t0 = _layer0(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    scale = rng.normal(size=jcfg.d_model).astype(np.float32)
    _close(TL.rmsnorm(_t(x), _t(scale), 1e-5),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
           rtol=1e-6, atol=1e-6)
    q = rng.normal(size=(2, 40, jcfg.n_heads, jcfg.d_head)).astype(np.float32)
    _close_layer(TL.apply_rope(_t(q), _t(pos), jcfg.rope_theta),
                 JL.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                               jcfg.rope_theta))
    _close(TL.rope_freqs(jcfg.d_head, jcfg.rope_theta),
           JL.rope_freqs(jcfg.d_head, jcfg.rope_theta), rtol=1e-6, atol=0)
    for got, want in zip(
            TL.causal_attention_with_kv(_t(x), t0, tcfg, _t(pos)),
            JL.causal_attention_with_kv(jnp.asarray(x), j0, jcfg,
                                        jnp.asarray(pos))):
        _close_layer(got, want)
    if jcfg.moe:
        (ty, ta), (jy, ja) = (TL.moe_mlp(_t(x), t0, tcfg),
                              JL.moe_mlp(jnp.asarray(x), j0, jcfg))
        _close_layer(ty, jy)
        _close(ta, ja, rtol=1e-6, atol=1e-7)
    else:
        _close_layer(TL.dense_mlp(_t(x), t0, tcfg),
                     JL.dense_mlp(jnp.asarray(x), j0, jcfg))
    # decode at positions inside and (for the ring) past the cache
    ck = rng.normal(size=(2, 30, jcfg.n_kv_heads, jcfg.d_head)
                    ).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    for position in (0, 17, 29, 45):
        got = TL.decode_attention(_t(x[:, :1]), t0, tcfg, _t(ck), _t(cv),
                                  position)
        want = JL.decode_attention(jnp.asarray(x[:, :1]), j0, jcfg,
                                   jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.int32(position))
        for g, w in zip(got, want):
            _close_layer(g, w)


def test_decode_attention_writes_the_caller_cache_in_place():
    _, tcfg, _, t0 = _layer0("mixtral-8x22b")
    x = torch.randn(2, 1, tcfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    ck = torch.zeros(2, 8, tcfg.n_kv_heads, tcfg.d_head)
    cv = torch.zeros_like(ck)
    _, k2, v2 = TL.decode_attention(x, t0, tcfg, ck, cv, 11)   # slot 11 % 8
    assert k2 is ck and v2 is cv
    assert bool(ck[:, 3].abs().sum() > 0) and float(ck[:, 4:].abs().sum()) == 0


# ---------------------------------------------------------------------------
# the float8 KV cache
# ---------------------------------------------------------------------------

def _f8_probe_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = np.array([0.0, -0.0, 1e-9, 2.0 ** -10, 2.0 ** -9 * 1.5, 100.0,
                      447.0, 448.0, 455.0, 456.0, 460.0, 463.9, 464.0,
                      464.01, 470.0, 480.0, 500.0, 1e4, 1e38, np.inf,
                      np.nan], np.float32)
    neg_nan = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)
    return np.concatenate(
        [edges, -edges, neg_nan, np.linspace(-600, 600, 24001,
                                             dtype=np.float32)]
        + [(rng.normal(size=20000) * s).astype(np.float32)
           for s in (2.0 ** -8, 1e-3, 1.0, 30.0, 300.0, 3000.0)])


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_f8_cache_cast_bytes_equal_jax(src):
    """f32 and bf16 K/V into float8_e4m3fn: the same bytes as the
    reference's cast, NaN (with the sign) past ±464 and for ±inf and NaN,
    where ``torch.Tensor.to`` alone saturates to ±448."""
    # the same input bits in both packages (their f32 → bf16 casts of a
    # negative NaN differ, which is not the cache's cast)
    jx = jnp.asarray(_f8_probe_values()).astype(
        {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[src])
    bits = np.asarray(jx).view({"float32": np.int32,
                                "bfloat16": np.int16}[src])
    tx = torch.from_numpy(bits.copy()).view(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[src])
    want = np.asarray(jx.astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = TL.cache_cast(tx, torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    assert np.array_equal(got.view(torch.uint8).numpy(), want)
    # the saturating cast alone would not do
    sat = tx.to(torch.float8_e4m3fn)
    assert not np.array_equal(sat.view(torch.uint8).numpy(), want)
    # other cache dtypes are a plain cast
    assert torch.equal(TL.cache_cast(tx, torch.bfloat16).view(torch.int16),
                       tx.bfloat16().view(torch.int16))


def test_f8_cache_prefill_and_decode_bytes_equal_jax():
    """A prefill and a decode step with an f8 cache whose K/V reach past
    ±464 (wk, wv scaled ×300): every byte the prefill stores is the
    reference's, NaN (with its sign) included, and so is the decode's new
    slot in layer 0.  Layer 0's attention then reads those NaNs, so layer
    1's new K/V are NaN from arithmetic in both packages, whose sign bit
    neither promises: there the NaNs agree, not their signs."""
    jcfg = dataclasses.replace(jconfigs.get_arch("phi4-mini-3.8b").smoke_cfg(),
                               cache_dtype="float8_e4m3fn")
    tcfg = dataclasses.replace(tconfigs.get_arch("phi4-mini-3.8b").smoke_cfg(),
                               cache_dtype="float8_e4m3fn")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    for k in ("layers/wk", "layers/wv"):
        jp[k] = jp[k] * 300.0
    tp = lm_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              device=CPU)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 17)
                                            ).astype(np.int32)
    _, jc = JM.prefill(jp, jnp.asarray(tok[:, :16]), jcfg, cache_len=20)
    _, tc = TM.prefill(tp, torch.from_numpy(tok[:, :16]), tcfg, cache_len=20)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.float8_e4m3fn
        got, want = _np(tc[name]), _np(jc[name])
        nan = (want & 0x7F) == 0x7F
        assert 0.3 < nan[:, :, :16].mean() < 0.9     # past ±464, and not
        assert np.array_equal(got, want)
    _, jc = JM.decode_step(jp, jc, jnp.asarray(tok[:, 16]), jnp.int32(16),
                           jcfg)
    _, tc = TM.decode_step(tp, tc, torch.from_numpy(tok[:, 16]), 16, tcfg)
    for name in ("k", "v"):
        got, want = _np(tc[name]), _np(jc[name])
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1, :, :16], want[1, :, :16])
        assert np.array_equal((got[1] & 0x7F) == 0x7F,
                              (want[1] & 0x7F) == 0x7F)


def test_f8_kv_cache_structural():
    """Twin of tests/test_models.py::test_f8_kv_cache_structural."""
    cfg = tconfigs.get_arch("phi4-mini-3.8b").smoke_cfg()
    cfg8 = dataclasses.replace(cfg, cache_dtype="float8_e4m3fn")
    params = TM.init_params(cfg, 0, device=CPU)
    B, S = 2, 16
    tokens = _rand_tokens(cfg, (B, S), 1)
    lf, _ = TM.forward(params, tokens, cfg)
    lp, cache = TM.prefill(params, tokens[:, :-1], cfg8, cache_len=S + 4)
    assert cache["k"].dtype == torch.float8_e4m3fn
    ld, _ = TM.decode_step(params, cache, tokens[:, -1], S - 1, cfg8)
    drift = float((ld - lf[:, -1]).abs().max())
    assert drift < 0.5, f"f8 cache logit drift {drift}"
    agree = (ld.argmax(-1) == lf[:, -1].argmax(-1)).float().mean()
    assert float(agree) >= 0.5


# ---------------------------------------------------------------------------
# top-k ties
# ---------------------------------------------------------------------------

def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(3)
    # few distinct values: most rows hold ties, some across the k-th place
    probs = rng.integers(0, 4, (500, 40)).astype(np.float32) / 8
    for k in (1, 2, 8):
        tv, ti = TL.top_k(torch.from_numpy(probs), k)
        jv, ji = lax.top_k(jnp.asarray(probs), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_moe_routes_tied_experts_as_the_reference():
    """Experts 1 and 2 (and 0 and 3) get identical router columns, so every
    token's router probabilities tie; the reference routes each tie to the
    lower expert, and so must the port (the dispatch and the output)."""
    jcfg, tcfg, j0, t0 = _layer0("granite-moe-3b-a800m")
    r = np.array(j0["router"])
    r[:, 2], r[:, 3] = r[:, 1], r[:, 0]
    j0 = dict(j0, router=jnp.asarray(r))
    t0 = dict(t0, router=torch.from_numpy(r))
    x = np.random.default_rng(4).normal(size=(2, 24, jcfg.d_model)
                                        ).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, jcfg.d_model)
                           @ jnp.asarray(r), axis=-1)
    jv, ji = lax.top_k(probs, jcfg.moe.top_k)
    tv, ti = TL.top_k(torch.softmax(torch.from_numpy(x).reshape(
        -1, jcfg.d_model) @ torch.from_numpy(r), dim=-1), jcfg.moe.top_k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    (ty, ta), (jy, ja) = (TL.moe_mlp(_t(x), t0, tcfg),
                          JL.moe_mlp(jnp.asarray(x), j0, jcfg))
    _close_layer(ty, jy)
    _close(ta, ja, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# twins of tests/test_models.py:25-115
# ---------------------------------------------------------------------------

def test_causality_future_tokens_do_not_leak():
    cfg = _tiny_cfg()
    params = TM.init_params(cfg, 0, device=CPU)
    t1 = _rand_tokens(cfg, (1, 24), 1)
    t2 = t1.clone()
    t2[0, 20] = (t1[0, 20] + 1) % cfg.vocab               # a LATE token
    l1, _ = TM.forward(params, t1, cfg)
    l2, _ = TM.forward(params, t2, cfg)
    np.testing.assert_allclose(l1[0, :20].numpy(), l2[0, :20].numpy(),
                               atol=1e-6)
    assert not np.allclose(l1[0, 20].numpy(), l2[0, 20].numpy())


def test_gqa_with_kv_equal_heads_is_mha():
    cfg = _tiny_cfg(n_kv_heads=4)
    params = TM.init_params(cfg, 0, device=CPU)
    tokens = _rand_tokens(cfg, (2, 16), 1)
    base, _ = TM.forward(params, tokens, cfg)
    perm = torch.tensor([2, 0, 3, 1])
    p2 = dict(params)
    for nm in ("wq", "wk", "wv"):
        p2[f"layers/{nm}"] = params[f"layers/{nm}"][:, :, perm, :]
    p2["layers/wo"] = params["layers/wo"][:, perm, :, :]
    out, _ = TM.forward(p2, tokens, cfg)
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_attention_chunking_is_exact():
    cfg_a, cfg_b = _tiny_cfg(attn_q_chunk=4), _tiny_cfg(attn_q_chunk=1024)
    params = TM.init_params(cfg_a, 0, device=CPU)
    tokens = _rand_tokens(cfg_a, (2, 16), 1)
    la, _ = TM.forward(params, tokens, cfg_a)
    lb, _ = TM.forward(params, tokens, cfg_b)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-3, atol=1e-5)
    assert TL.q_chunk(cfg_a, 16) == 4 and TL.q_chunk(cfg_b, 16) == 16
    assert TL.q_chunk(_tiny_cfg(attn_q_chunk=1024), 4608) == 768


def test_scan_vs_unrolled_layers_identical():
    cfg_s, cfg_u = _tiny_cfg(scan_layers=True), _tiny_cfg(scan_layers=False)
    params = TM.init_params(cfg_s, 0, device=CPU)
    tokens = _rand_tokens(cfg_s, (2, 16), 1)
    ls, _ = TM.forward(params, tokens, cfg_s)
    lu, _ = TM.forward(params, tokens, cfg_u)
    np.testing.assert_allclose(ls.numpy(), lu.numpy(), rtol=1e-3, atol=1e-5)


def test_vocab_padding_preserves_loss():
    cfg = _tiny_cfg(vocab=60)
    cfg_pad = _tiny_cfg(vocab=60, pad_vocab_to_multiple=32)     # → 64
    params = TM.init_params(cfg, 0, device=CPU)
    pp = dict(params)
    pp["emb"] = torch.zeros(cfg_pad.vocab_padded, cfg.d_model)
    pp["emb"][:60] = params["emb"]
    pp["head"] = torch.zeros(cfg.d_model, cfg_pad.vocab_padded)
    pp["head"][:, :60] = params["head"]
    tokens = _rand_tokens(cfg, (2, 16), 1)
    labels = _rand_tokens(cfg, (2, 16), 2)
    l1, _ = TM.loss_fn(params, tokens, labels, cfg)
    l2, _ = TM.loss_fn(pp, tokens, labels, cfg_pad)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)


def test_moe_capacity_dropping_monotone():
    def mk(cf):
        return _tiny_cfg(moe=MoEConfig(n_experts=4, top_k=2,
                                       capacity_factor=cf))
    cfg_hi = mk(8.0)
    params = TM.init_params(cfg_hi, 0, device=CPU)
    tokens = _rand_tokens(cfg_hi, (2, 32), 1)
    hi, _ = TM.forward(params, tokens, cfg_hi)
    lo, _ = TM.forward(params, tokens, mk(0.25))
    assert not np.allclose(hi.numpy(), lo.numpy())
    mid, _ = TM.forward(params, tokens, mk(8.0))
    np.testing.assert_allclose(hi.numpy(), mid.numpy())


def test_init_params_rules():
    """Sorted names, ones for norms, zeros for biases, normal · fan_in^-½
    from the generator: the same seed gives the same params."""
    cfg = tconfigs.get_arch("qwen1.5-4b").smoke_cfg()
    a = TM.init_params(cfg, 7, device=CPU)
    b = TM.init_params(cfg, torch.Generator().manual_seed(7), device=CPU)
    assert list(a) == sorted(TM.param_shapes(cfg))
    for k, v in a.items():
        assert tuple(v.shape) == TM.param_shapes(cfg)[k]
        assert v.dtype == torch.float32 and torch.equal(v, b[k])
    assert torch.equal(a["layers/attn_norm"], torch.ones(2, cfg.d_model))
    assert float(a["layers/bq"].abs().sum()) == 0
    std = float(a["layers/wi_gate"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


# ---------------------------------------------------------------------------
# twins of tests/test_archs_smoke.py:50, :83 and :137
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_decode_consistency(arch):
    cfg = tconfigs.get_arch(arch).smoke_cfg()
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = TM.init_params(cfg, 0, device=CPU)
    B, S = 2, 16
    tokens = _rand_tokens(cfg, (B, S), 0)
    logits_full, _ = TM.forward(params, tokens, cfg)
    logits_pre, cache = TM.prefill(params, tokens[:, :-1], cfg,
                                   cache_len=S + 4)
    np.testing.assert_allclose(logits_pre.numpy(),
                               logits_full[:, -2].numpy(), rtol=2e-2,
                               atol=2e-2)
    logits_dec, cache = TM.decode_step(params, cache, tokens[:, -1], S - 1,
                                       cfg)
    np.testing.assert_allclose(logits_dec.numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_output_shapes(arch):
    cfg = tconfigs.get_arch(arch).smoke_cfg()
    params = TM.init_params(cfg, 0, device=CPU)
    tokens = torch.zeros((2, 32), dtype=torch.int32)
    logits, aux = TM.forward(params, tokens, cfg)
    assert logits.shape == (2, 32, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all())
    if cfg.moe:
        assert float(aux) >= 0.0


def test_mixtral_sliding_window_masks_history():
    cfg = tconfigs.get_arch("mixtral-8x22b").smoke_cfg()       # window 32
    params = TM.init_params(cfg, 0, device=CPU)
    S = 3 * cfg.sliding_window
    tokens = _rand_tokens(cfg, (1, S), 1)
    logits, _ = TM.forward(params, tokens, cfg)
    tokens2 = tokens.clone()
    tokens2[0, 2] = (tokens[0, 2] + 1) % cfg.vocab
    logits2, _ = TM.forward(params, tokens2, cfg)
    np.testing.assert_allclose(logits[0, -1].numpy(), logits2[0, -1].numpy(),
                               atol=1e-5)
    assert not np.allclose(logits[0, 3].numpy(), logits2[0, 3].numpy(),
                           atol=1e-5)
