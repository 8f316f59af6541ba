"""The port's paged attention against the JAX package on the CPU: the plain
version of kernel K1 (both entry points) against the Pallas kernel in
interpret mode and the JAX oracle, then the paged decode and verify layers,
the continuation prefill and the model's paged steps on converted weights at
the reduced smollm-135m size.  The same numpy inputs go to both sides."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.paged_attention.paged_attention import (
    paged_decode_attention_pallas, paged_window_attention_pallas)
from repro.kernels.paged_attention.xla import paged_decode_attention_xla
from repro.kernels.paged_attention.ref import (
    paged_decode_attention_reference as jax_paged_decode_reference,
    paged_window_attention_reference as jax_paged_window_reference)
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro_torch.configs import get_config
from repro_torch.configs.base import LayerSpec
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_window_attention)
from repro_torch.kernels.paged_attention.ops import paged_splits
from repro_torch.models import api, attention
from repro_torch.params import from_jax_params

TOL = 2e-5          # plain fp32 vs the JAX kernel: summation order only
MODEL_TOL = 1e-5

# (b, h, kv, d, block_size, logical_blocks, n_phys_blocks, softcap): the
# JAX package's CASES of tests/test_paged_attention.py
CASES = [
    (2, 4, 2, 16, 8, 4, 16, None),
    (3, 6, 3, 8, 16, 3, 24, 50.0),
    (1, 8, 8, 32, 4, 6, 32, None),
    (4, 16, 2, 64, 16, 2, 48, None),
]


def _pools(rng, case, dv=None):
    b, h, kv, d, bs, nb, n, _ = case
    kp = rng.standard_normal((n, bs, kv, d)).astype(np.float32)
    vp = rng.standard_normal((n, bs, kv, dv or d)).astype(np.float32)
    bt = rng.permutation(n)[:b * nb].reshape(b, nb).astype(np.int32)
    return kp, vp, bt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_paged_decode_plain_matches_jax(rng, case):
    b, h, kv, d, bs, nb, n, cap = case
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp, vp, bt = _pools(rng, case)
    kv_len = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    got = paged_decode_attention(*_t(q, kp, vp, bt, kv_len), softcap=cap).numpy()
    pallas = paged_decode_attention_pallas(
        q, kp, vp, jnp.asarray(bt), jnp.asarray(kv_len), softcap=cap,
        interpret=True)
    oracle = jax_paged_decode_reference(q, kp, vp, bt, kv_len, softcap=cap)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_paged_decode_plain_row_without_keys_is_zero(rng, case):
    """A row at kv_len 0 (a free slot) is exactly 0, as in
    ``paged_decode_attention_xla`` and the CUDA kernel; the other rows
    match it too."""
    b, h, kv, d, bs, nb, n, cap = case
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp, vp, bt = _pools(rng, case)
    kv_len = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    kv_len[-1] = 0
    got = paged_decode_attention(*_t(q, kp, vp, bt, kv_len), softcap=cap).numpy()
    want = paged_decode_attention_xla(q, kp, vp, jnp.asarray(bt),
                                      jnp.asarray(kv_len), softcap=cap)
    assert (got[-1] == 0).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_paged_window_plain_matches_jax(rng, case, t):
    b, h, kv, d, bs, nb, n, cap = case
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kp, vp, bt = _pools(rng, case, dv=d + 8)          # Dv != D as well
    base = rng.integers(0, nb * bs - t + 1, size=b).astype(np.int32)
    got = paged_window_attention(*_t(q, kp, vp, bt, base), softcap=cap).numpy()
    pallas = paged_window_attention_pallas(
        q, kp, vp, jnp.asarray(bt), jnp.asarray(base), softcap=cap,
        interpret=True)
    oracle = jax_paged_window_reference(q, kp, vp, bt, base, softcap=cap)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_padded_table_tail_is_inert(rng, t):
    """Entries past the valid pages point at the null block, whose contents
    are poisoned: the output does not change (the JAX package's
    test_padded_table_tail_is_inert, through both entry points)."""
    b, h, kv, d, bs, nb, n = 2, 4, 2, 16, 8, 4, 16
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kp = rng.standard_normal((n, bs, kv, d)).astype(np.float32)
    vp = rng.standard_normal((n, bs, kv, d)).astype(np.float32)
    bt = (1 + rng.permutation(n - 1)[:b * nb].reshape(b, nb)).astype(np.int32)
    base = np.array([bs + 3 - t, 2 * bs - t], np.int32)   # <= 2 pages valid
    bt2, kp2, vp2 = bt.copy(), kp.copy(), vp.copy()
    bt2[:, 2:] = 0
    kp2[0], vp2[0] = 1e3, -1e3
    for entry, qq, kl in ((paged_window_attention, q, base),
                          (paged_decode_attention, q[:, 0], base + 1)):
        out1 = entry(*_t(qq, kp, vp, bt, kl)).numpy()
        out2 = entry(*_t(qq, kp2, vp2, bt2, kl)).numpy()
        np.testing.assert_allclose(out1, out2, atol=TOL, rtol=TOL)
    want = paged_window_attention_pallas(
        q, kp2, vp2, jnp.asarray(bt2), jnp.asarray(base), interpret=True)
    np.testing.assert_allclose(paged_window_attention(*_t(q, kp, vp, bt, base))
                               .numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("nb,bs", [(1, 8), (4, 8), (6, 8), (9, 16), (10, 16),
                                   (66, 16), (17, 128), (1000, 16), (3, 1),
                                   (4096, 8)])
def test_paged_splits_cover_every_page_once(nb, bs):
    """K1's split of a table into clusters of blocks: 1-16 splits of P
    pages, split i covering [i*P, min((i+1)*P, nb)); together they cover
    every page exactly once and none is empty.  A function of (nb, bs)
    only, never of the lengths or of T."""
    splits, per = paged_splits(nb, bs)
    assert 1 <= splits <= 16
    ranges = [range(i * per, min((i + 1) * per, nb)) for i in range(splits)]
    assert [p for r in ranges for p in r] == list(range(nb))
    assert all(len(r) > 0 for r in ranges)
    assert splits <= max(1, min(16, -(-nb * bs // 64)))
    assert list(inspect.signature(paged_splits).parameters) == ["nb", "bs"]


def test_wrappers_check_shapes_and_devices():
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(8, 4, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree"):
        paged_decode_attention(q, pool, pool, bt, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="KV heads"):
        paged_decode_attention(torch.zeros(2, 3, 16), pool, pool, bt,
                               torch.ones(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        paged_window_attention(q[:, None].double(), pool, pool, bt,
                               torch.ones(2, dtype=torch.int32))


# ------------------------------------------------------------ model layers

@pytest.fixture(scope="module")
def models():
    """(port cfg, JAX cfg, JAX params, port model with the JAX weights)."""
    jcfg = jax_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, model


def _layer0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["blocks"]["l0"]["mixer"])


def _layer_pool(rng, cfg, n=12, bs=8):
    shape = (n, bs, cfg.n_kv_heads, cfg.head_dim_eff)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _close(got: dict, want: dict, atol=MODEL_TOL):
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, err_msg=key)


def test_attn_paged_decode_matches_jax(rng, models):
    cfg, jcfg, jparams, model = models
    b = 3
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pool = _layer_pool(rng, cfg)
    bt = rng.permutation(12)[:b * 3].reshape(b, 3).astype(np.int32)
    kv_len = np.array([5, 16, 20], np.int32)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    y, tpool = attention.attn_paged_decode(
        cfg, LayerSpec(), model.blocks[0].mixer, torch.from_numpy(x), tpool,
        torch.from_numpy(bt), torch.from_numpy(kv_len))
    jy, jpool = jax_attn.attn_paged_decode(
        jcfg, jcfg.layer_plan()[0], _layer0(jparams), x,
        jax.tree.map(jnp.asarray, pool), jnp.asarray(bt), jnp.asarray(kv_len))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MODEL_TOL)
    _close(tpool, jpool)


def test_attn_paged_spec_matches_jax(rng, models):
    cfg, jcfg, jparams, model = models
    b, t, bs = 3, 4, 8
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    pool = _layer_pool(rng, cfg)
    bt = (1 + rng.permutation(11)[:b * 3]).reshape(b, 3).astype(np.int32)
    kv_len = np.array([3, 12, 0], np.int32)
    win = np.array([4, 2, 0])                   # row 2: a masked slot
    pos = kv_len[:, None] + np.arange(t)[None, :]
    valid = np.arange(t)[None, :] < win[:, None]
    blk = np.where(valid, np.take_along_axis(bt, pos // bs, axis=1),
                   0).astype(np.int32)
    off = np.where(valid, pos % bs, 0).astype(np.int32)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    y, tpool = attention.attn_paged_spec(
        cfg, LayerSpec(), model.blocks[0].mixer, torch.from_numpy(x), tpool,
        *_t(bt, kv_len, blk, off))
    jy, jpool = jax_attn.attn_paged_spec(
        jcfg, jcfg.layer_plan()[0], _layer0(jparams), x,
        jax.tree.map(jnp.asarray, pool), jnp.asarray(bt), jnp.asarray(kv_len),
        jnp.asarray(blk),
        jnp.asarray(off))
    np.testing.assert_allclose(y.numpy()[:2], np.asarray(jy)[:2],
                               atol=MODEL_TOL)
    for key in ("k", "v"):                      # the null block is garbage
        np.testing.assert_allclose(tpool[key].numpy()[1:],
                                   np.asarray(jpool[key])[1:], atol=MODEL_TOL)


def test_continuation_prefill_matches_jax(rng, models):
    """api.prefill over a suffix with the prefix's K/V: logits and the
    suffix cache agree with the JAX package, and with the whole-prompt
    prefill's last logits."""
    cfg, jcfg, jparams, model = models
    n, p, cl = 21, 13, 8
    toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
    whole, cache = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                               cache_len=n)
    prefix = [{k: c[k][:, :p] for k in ("k", "v")} for c in cache]
    suffix = np.zeros((1, cl), np.int32)
    suffix[0, :n - p] = toks[0, p:]
    kv_len = np.array([n - p], np.int32)
    got, gcache = api.prefill(cfg, model,
                              {"tokens": torch.from_numpy(suffix).long()},
                              cache_len=cl, kv_len=torch.from_numpy(kv_len),
                              prefix_kv=prefix)
    jprefix = {"l0": {"mixer": {
        k: np.stack([c[k].numpy() for c in prefix]) for k in ("k", "v")}}}
    want, jcache = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(suffix)},
                                   cache_len=cl, kv_len=jnp.asarray(kv_len),
                                   prefix_kv=jprefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=MODEL_TOL)
    for layer, c in enumerate(gcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                c[key].numpy(), np.asarray(jcache["l0"]["mixer"][key][layer]),
                atol=MODEL_TOL)


def _stack_pools(pools):
    """The port's per-layer pools -> the reference's stacked tree."""
    return {"l0": {"mixer": {k: jnp.asarray(np.stack([p[k].numpy()
                                                      for p in pools]))
                             for k in ("k", "v")}}}


@pytest.mark.parametrize("t", [1, 3])
def test_paged_steps_match_jax(rng, models, t):
    """api.paged_decode_step (t=1) and api.paged_spec_step on converted
    weights and pools: logits and every layer's pool."""
    cfg, jcfg, jparams, model = models
    b, n, bs = 3, 12, 8
    pools = api.init_paged_pools(cfg, n, bs, device="cpu")
    for p in pools:
        for key in ("k", "v"):
            p[key].copy_(torch.from_numpy(
                rng.standard_normal(p[key].shape).astype(np.float32)))
    jpools = _stack_pools(pools)
    bt = (1 + rng.permutation(n - 1)[:b * 3]).reshape(b, 3).astype(np.int32)
    kv_len = np.array([4, 9, 14], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    if t == 1:
        got, pools = api.paged_decode_step(cfg, model, tt, pools,
                                           *_t(bt, kv_len))
        want, jpools = jax_api.paged_decode_step(
            jcfg, jparams, jnp.asarray(toks), jpools, jnp.asarray(bt),
            jnp.asarray(kv_len))
    else:
        pos = kv_len[:, None] + np.arange(t)[None, :]
        blk = np.take_along_axis(bt, pos // bs, axis=1).astype(np.int32)
        off = (pos % bs).astype(np.int32)
        got, pools = api.paged_spec_step(cfg, model, tt, pools,
                                         *_t(bt, kv_len, blk, off))
        want, jpools = jax_api.paged_spec_step(
            jcfg, jparams, jnp.asarray(toks), jpools, jnp.asarray(bt),
            jnp.asarray(kv_len), jnp.asarray(blk), jnp.asarray(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL)
    mine = _stack_pools(pools)["l0"]["mixer"]
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(mine[key]),
                                   np.asarray(jpools["l0"]["mixer"][key]),
                                   atol=MODEL_TOL)


def test_init_paged_pools_matches_jax_layout(models):
    cfg, jcfg, *_ = models
    pools = api.init_paged_pools(cfg, 5, 8, device="cpu")
    jpools = jax_api.init_paged_pools(jcfg, 5, 8)
    assert len(pools) == cfg.n_layers
    for key in ("k", "v"):
        assert (len(pools),) + tuple(pools[0][key].shape) == \
            jpools["l0"]["mixer"][key].shape
        assert all(not p[key].any() for p in pools)
    assert api.paged_compatible(cfg) == (True, "")
    windowed = dataclasses.replace(cfg, sliding_window=4)
    ok, why = api.paged_compatible(windowed)
    assert not ok and "ring cache" in why
    with pytest.raises(ValueError, match="ring cache"):
        api.init_paged_pools(windowed, 4, 8, device="cpu")
