"""The port's WKV6 op on the CPU (its plain chunked version) against the JAX
package's oracle, chunked XLA version and Pallas kernel (interpret mode),
on the same numpy inputs, at the JAX package's own cases and tolerances;
the decode step, a carried initial state, and the wrapper's dispatch.  The
kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ref import wkv6_reference
from repro.kernels.wkv6.wkv6 import wkv6_pallas
from repro.kernels.wkv6.xla import wkv6_step as jax_wkv6_step
from repro.kernels.wkv6.xla import wkv6_xla
from repro_torch.kernels.wkv6 import (wkv6, wkv6_chunked, wkv6_sequential,
                                      wkv6_step)

# the JAX package's CASES of tests/test_kernels_wkv6.py: b, t, h, d, dv, chunk
CASES = [(2, 64, 3, 16, 16, 16), (1, 50, 2, 8, 8, 16), (2, 33, 4, 32, 32, 8),
         (1, 128, 2, 64, 64, 32)]
TOL = dict(atol=5e-5, rtol=5e-4)      # the JAX package's chunked-vs-oracle


def _gen(rng, b, t, h, d, dv, decay_scale=2.0):
    r = rng.standard_normal((b, t, h, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, t, h, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    w = np.exp(-np.exp(rng.standard_normal((b, t, h, d)) * decay_scale)
               ).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    return r, k, v, w, u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _jax(impl, r, k, v, w, u, chunk):
    if impl == "reference":
        return wkv6_reference(r, k, v, w, u)
    if impl == "xla":
        return wkv6_xla(r, k, v, w, u, chunk=chunk)
    return wkv6_pallas(r, k, v, w, u, chunk=chunk, interpret=True)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("impl", ["reference", "xla", "pallas"])
def test_wkv6_matches_jax(rng, case, impl):
    b, t, h, d, dv, chunk = case
    arrs = _gen(rng, b, t, h, d, dv)
    n = wkv6.launches
    out, state = wkv6(*_t(*arrs), chunk=chunk)
    assert wkv6.launches == n          # the CPU path launches nothing
    want_o, want_s = _jax(impl, *arrs, chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_wkv6_sequential_matches_jax_oracle(rng, case):
    b, t, h, d, dv, _ = case
    arrs = _gen(rng, b, t, h, d, dv)
    out, state = wkv6_sequential(*_t(*arrs))
    want_o, want_s = wkv6_reference(*arrs)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=1e-4)


def test_wkv6_extreme_decay_stable(rng):
    """w near 0 (instant forget) gives no inf/nan and matches the oracle:
    the pairwise log-space form keeps every exponent <= 0."""
    r, k, v, w, u = _gen(rng, 1, 48, 2, 16, 16, decay_scale=4.0)
    w = np.minimum(w, 1e-6).astype(np.float32)
    out, state = wkv6(*_t(r, k, v, w, u), chunk=16)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    want_o, want_s = wkv6_reference(r, k, v, w, u)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), **TOL)


def test_wkv6_step_chain_matches_scan(rng):
    b, t, h, d, dv = 2, 12, 3, 16, 16
    arrs = _gen(rng, b, t, h, d, dv)
    r, k, v, w, u = _t(*arrs)
    want_o, want_s = wkv6_reference(*arrs)
    s = torch.zeros(b, h, d, dv)
    outs = []
    for i in range(t):
        o, s = wkv6_step(r[:, i], k[:, i], v[:, i], w[:, i], u, s)
        outs.append(o)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), np.asarray(want_o),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=1e-4)


def test_wkv6_step_matches_jax_step(rng):
    b, h, d, dv = 3, 4, 16, 8
    r, k, v, w, u = (x[:, 0] if x.ndim == 4 else x
                     for x in _gen(rng, b, 1, h, d, dv))
    s = rng.standard_normal((b, h, d, dv)).astype(np.float32)
    out, state = wkv6_step(*_t(r, k, v, w, u, s))
    want_o, want_s = jax_wkv6_step(r, k, v, w, u, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_carried_state(rng, chunk):
    """Two halves with the state carried through ``s0`` equal one shot, and
    a given ``s0`` matches the JAX op (the XLA path, which takes it)."""
    b, t, h, d, dv = 1, 64, 2, 16, 16
    r, k, v, w, u = _t(*_gen(rng, b, t, h, d, dv))
    o_full, s_full = wkv6(r, k, v, w, u, chunk=chunk)
    o1, s1 = wkv6(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, chunk=chunk)
    o2, s2 = wkv6(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, s1,
                  chunk=chunk)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o_full.numpy(),
                               atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=2e-5, rtol=2e-4)
    jo, js = wkv6_xla(*(x[:, 32:].numpy() for x in (r, k, v, w)), u.numpy(),
                      s1.numpy(), chunk=chunk)
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js), **TOL)


def test_wkv6_chunk_is_a_schedule(rng):
    """Chunk length and T not a multiple of it change rounding only."""
    arrs = _t(*_gen(rng, 2, 45, 2, 16, 16))
    want_o, want_s = wkv6_sequential(*arrs)
    for chunk in (1, 7, 32, 64):
        out, state = wkv6_chunked(*arrs, chunk=chunk)
        np.testing.assert_allclose(out.numpy(), want_o.numpy(), **TOL)
        np.testing.assert_allclose(state.numpy(), want_s.numpy(), **TOL)


def test_wkv6_bf16_inputs_keep_dtype(rng):
    r, k, v, w, u = _t(*_gen(rng, 1, 20, 2, 16, 16))
    out, state = wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    want, _ = wkv6(*(x.bfloat16().float() for x in (r, k, v)), w, u)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=2e-2)


def test_wkv6_dispatch_and_checks(rng):
    r, k, v, w, u = _t(*_gen(rng, 1, 8, 2, 16, 16))
    n, m = wkv6.launches, wkv6.meta_calls
    # meta tensors (the dry run) give the outputs' shapes: no launch
    out, state = wkv6(*(x.to("meta") for x in (r, k, v, w, u)))
    assert (out.device.type, tuple(out.shape), tuple(state.shape)) == \
        ("meta", (1, 8, 2, 16), (1, 2, 16, 16))
    assert wkv6.meta_calls == m + 1
    with pytest.raises(TypeError):
        wkv6(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(ValueError, match="disagree"):
        wkv6(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match="disagree"):
        wkv6(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="disagree"):
        wkv6(r, k, v, w, u, torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError):
        wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    with pytest.raises(ValueError, match="B, T, H, D"):
        wkv6(r[0], k[0], v[0], w[0], u)
    with pytest.raises(ValueError, match="different devices"):
        wkv6(r, k, v, w, u.to("meta"))
    assert wkv6.launches == n


@pytest.mark.parametrize("dv", [8, 6, 96])
def test_wkv6_value_columns_are_independent(rng, dv):
    """What the kernel's split over its 4-block cluster rests on: the
    recurrence over the kernel's slices of the value columns (ceil(Dv / 4)
    each; at Dv = 6 the fourth is empty and gives no part), of v and s0
    both, concatenated, equals it over all columns; and both match the JAX
    chunked XLA version."""
    b, t, h, d, chunk = 2, 40, 3, 16, 16
    r, k, v, w, u = _gen(rng, b, t, h, d, dv)
    s0 = rng.standard_normal((b, h, d, dv)).astype(np.float32)
    tr, tk, tv, tw, tu, ts0 = _t(r, k, v, w, u, s0)
    full_o, full_s = wkv6_chunked(tr, tk, tv, tw, tu, ts0, chunk=chunk)
    dvs = -(-dv // 4)
    parts = [wkv6_chunked(tr, tk, tv[..., j:j + dvs].contiguous(), tw, tu,
                          ts0[..., j:j + dvs].contiguous(), chunk=chunk)
             for j in range(0, dv, dvs)]
    assert sum(p[0].shape[-1] for p in parts) == dv
    np.testing.assert_allclose(torch.cat([p[0] for p in parts], -1).numpy(),
                               full_o.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(torch.cat([p[1] for p in parts], -1).numpy(),
                               full_s.numpy(), atol=1e-6, rtol=0)
    want_o, want_s = wkv6_xla(r, k, v, w, u, s0, chunk=chunk)
    np.testing.assert_allclose(full_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(full_s.numpy(), np.asarray(want_s), **TOL)
