"""The port's training path against the JAX package on the CPU, at reduced
sizes, f32: the loss and every parameter's gradient for eight archs, flash
attention's gradient (K2's backward on the card), the optimizers on
identical gradients, the train step over three steps with 1 and 4
micro-batches, and the reduced smollm learning."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.xla import flash_attention_xla
from repro.models import api as jax_api
from repro.training import OptConfig as JaxOptConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
from repro.training.optimizer import apply_updates as jax_apply_updates
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_grad,
                                                 flash_attention_reference)
from repro_torch.kernels.flash_attention import grad as fa_grad
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.train import batch_at, token_base
from repro_torch.models import api
from repro_torch.params import from_jax_params, stacked_leaves, to_jax_tree
from repro_torch.training import (OptConfig, TrainConfig, apply_updates,
                                  init_opt_state, init_training,
                                  make_train_step, train_state_tree)

LOSS_RTOL = 1e-5          # loss, relative
GRAD_TOL = 1e-4           # each gradient leaf, x its largest magnitude
# a leaf whose gradient is 0 in exact arithmetic (a key bias: softmax is
# invariant to a shift of a whole row of scores) is held to this, absolute
GRAD_ATOL = 1e-8
OPT_RTOL = 1e-6           # optimizer updates on identical inputs

ARCHS = ["smollm-135m", "qwen2-moe-a2.7b", "gemma2-27b", "minicpm3-4b",
         "qwen2-vl-7b", "rwkv6-3b", "jamba-1.5-large-398b", "whisper-medium"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run thousands of small torch ops; under the parallel
    test run the workers' intra-op thread pools oversubscribe the cores and
    slow them ~70x.  One thread per worker here, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _converted(arch: str, **reduced):
    """(port cfg, JAX cfg, JAX params, port model with the JAX weights,
    trainable), once a module: no test changes the weights."""
    jcfg = jax_get_config(arch).reduced(**reduced)
    cfg = get_config(arch).reduced(**reduced)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(_np_tree(jparams)))
    model.requires_grad_(True)
    return cfg, jcfg, jparams, model


def _loss_batch(cfg, rng, b=2, s=16) -> dict:
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((b, 16, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _assert_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        tol = GRAD_TOL * np.abs(ref).max() + GRAD_ATOL
        err = np.abs(np.asarray(got[name]) - ref).max()
        assert err <= tol, (name, err, tol)


# --------------------------------------------------------- loss and grads

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(rng, arch):
    cfg, jcfg, jparams, model = _converted(arch)
    batch = _loss_batch(cfg, rng)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jax_api.loss_fn(jcfg, p, bt), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, m = api.loss_fn(cfg, model, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(m["nll"]) == pytest.approx(float(jm["nll"]), rel=LOSS_RTOL)
    if cfg.moe is not None:
        assert float(jm["lb_loss"]) > 0
        assert float(m["lb_loss"]) == pytest.approx(float(jm["lb_loss"]),
                                                    rel=LOSS_RTOL)
    _assert_grads({n: g.numpy() for n, g in zip(named, grads)},
                  {k: v.numpy() for k, v in
                   from_jax_params(_np_tree(jgrads)).items()})


def test_lm_forward_matches_jax(rng):
    from repro.models import transformer as jax_T
    from repro_torch.models import transformer as T
    cfg, jcfg, jparams, model = _converted("qwen2-moe-a2.7b")
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlogits, jaux = jax_T.lm_forward(jcfg, jparams, jnp.asarray(toks))
    with torch.no_grad():
        logits, aux = T.lm_forward(cfg, model, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    assert float(aux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]),
                                                  rel=LOSS_RTOL)


def test_loss_chunks_sum_to_one_pass(rng):
    """lm_loss over 4 sequence chunks equals one pass (the reference's
    ``loss_chunk``)."""
    from repro_torch.models import transformer as T
    cfg, _, _, model = _converted("smollm-135m")
    batch = {k: torch.from_numpy(v) for k, v in _loss_batch(cfg, rng).items()}
    with torch.no_grad():
        whole, _ = T.lm_loss(cfg, model, batch)
        chunked, _ = T.lm_loss(cfg, model, batch, loss_chunk=4)
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)


# ------------------------------------------------- flash attention's grad

GRAD_CASES = [  # name, b, sq, skv, h, kv, d, dv, causal, window, softcap, q_offset
    ("causal_group2", 2, 16, 16, 4, 2, 8, 8, True, None, None, 0),
    ("noncausal_group1", 2, 16, 16, 4, 4, 8, 8, False, None, None, 0),
    ("q_offset_d_ne_dv", 1, 12, 20, 6, 2, 16, 8, True, None, None, 8),
    ("window", 2, 16, 16, 4, 2, 8, 8, True, 5, None, 0),
    ("softcap", 2, 16, 16, 4, 2, 8, 8, True, None, 2.0, 0),
    ("window_softcap", 2, 16, 16, 4, 2, 8, 8, True, 5, 2.0, 0),
    ("cross_sq_ne_skv", 1, 10, 24, 4, 1, 12, 8, False, None, None, 0),
    # rows 6.. over 4 keys, window 2: row 6 sees no key (a blind chunk)
    ("blind_rows", 1, 8, 4, 2, 1, 8, 8, False, 2, None, 6),
]


def _grad_inputs(case, dtype, seed=0):
    _, b, sq, skv, h, kv, d, dv, *_ = case
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (2 * torch.randn(*shape, generator=g) for shape in (
        (b, sq, h, d), (b, skv, kv, d), (b, skv, kv, dv), (b, sq, h, dv)))
    return [t.to(dtype) for t in (q, k, v, do)]


def _opts(case):
    causal, window, cap, qoff = case[8:]
    return dict(causal=causal, window=window, softcap=cap, q_offset=qoff)


@pytest.mark.parametrize("chunk_rows", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_flash_attention_grad_matches_autograd(monkeypatch, case, dtype,
                                               chunk_rows):
    """flash_attention_grad against autograd of the plain version on the
    same tensors, within 1e-5 (f32) or 2e-2 (bf16) of each gradient's
    largest magnitude; ``chunk_rows`` 3 runs it in chunks of 3 query rows
    (each reading only the keys its rows may see)."""
    q, k, v, do = _grad_inputs(case, dtype)
    b, _, skv, h = case[1], case[2], case[3], case[4]
    if chunk_rows:
        monkeypatch.setattr(fa_grad, "CHUNK_ELEMENTS", chunk_rows * b * h * skv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_reference(*leaves, **_opts(case))
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attention_grad(q, k, v, out.detach(), do, **_opts(case))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = (1e-5 if dtype == torch.float32 else 2e-2) \
            * w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_flash_attention_grad_matches_jax_vjp(case):
    """The reference's training gradient: jax.vjp of the blocked XLA
    attention, f32, within 1e-5 of each gradient's largest magnitude."""
    q, k, v, do = _grad_inputs(case, torch.float32, seed=1)
    out = flash_attention_reference(q, k, v, **_opts(case))
    got = flash_attention_grad(q, k, v, out, do, **_opts(case))
    jout, vjp = jax.vjp(lambda a, b_, c: flash_attention_xla(a, b_, c,
                                                             **_opts(case)),
                        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w in zip((out, *got), (jout, *vjp(jnp.asarray(do.numpy())))):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_flash_attention_function_runs_the_grad(monkeypatch):
    """The CUDA path's autograd.Function, with the kernel's launch stood in
    by the plain version: the gradient is flash_attention_grad's, each
    forward counts a launch and each backward a backward call; without
    grad the launch runs alone."""
    case = GRAD_CASES[2]
    q, k, v, do = _grad_inputs(case, torch.float32, seed=2)

    def launch(q, k, v, causal, window, softcap, q_offset, scale):
        flash_attention.launches += 1
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         softcap=softcap, q_offset=q_offset,
                                         scale=scale)
    monkeypatch.setattr(fa_ops, "_launch", launch)
    monkeypatch.setattr(flash_attention, "launches", 0)
    monkeypatch.setattr(flash_attention, "backward_calls", 0)
    opts = (case[8], case[9], case[10], case[11], case[6] ** -0.5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops._FlashAttention.apply(*leaves, *opts)
    got = torch.autograd.grad(out, leaves, do)
    want = flash_attention_grad(q, k, v, out.detach(), do, **_opts(case))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (flash_attention.launches, flash_attention.backward_calls) == (1, 1)


def test_flash_attention_on_cpu_stays_the_plain_version_under_autograd():
    case = GRAD_CASES[0]
    q, k, v, do = _grad_inputs(case, torch.float32, seed=3)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ga = torch.autograd.grad(flash_attention(*a, **_opts(case)), a, do)
    gb = torch.autograd.grad(flash_attention_reference(*b, **_opts(case)), b, do)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


# ------------------------------------------------------------- optimizers

# smollm: one stack of 2 layers; gemma2 at 4 layers: two leaves (local,
# global) of 2 layer groups each, layers 0 and 2 in one; whisper: an
# encoder and a decoder stack
OPT_ARCHS = {"smollm-135m": {}, "gemma2-27b": {"n_layers": 4},
             "whisper-medium": {}}


@pytest.fixture(scope="module")
def opt_models():
    """Per arch: (port cfg, JAX params tree, the port's named tensors)."""
    out = {}
    for arch, reduced in OPT_ARCHS.items():
        cfg, _, jparams, model = _converted(arch, **reduced)
        out[arch] = (cfg, jparams, {k: p.detach().clone()
                                    for k, p in model.named_parameters()})
    return out


def _two_steps(cfg, jparams, named, kind: str, stacks, rng):
    """Two updates from a zero state on identical numpy gradients, in both
    packages.  Returns ((port params, port state), (JAX params, state)),
    the port's in the reference's layout."""
    ocfg = OptConfig(kind=kind, lr=1e-2)
    jcfg = JaxOptConfig(kind=kind, lr=1e-2)
    params, state = named, init_opt_state(named, ocfg, stacks)
    jp, js = jparams, jax_init_opt_state(jparams, jcfg)
    for step in (1.0, 2.0):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32)
                 * (1.0 + 9.0 * (i % 2)) for i, (k, p) in enumerate(params.items())}
        params, state = apply_updates(params, {k: torch.from_numpy(g) for k, g
                                               in grads.items()}, state, step,
                                      ocfg, stacks)
        jgrads = jax.tree.map(jnp.asarray, to_jax_tree(cfg, grads))
        jp, js = jax_apply_updates(jp, jgrads, js, jnp.float32(step), jcfg)
    if kind == "adamw":
        port_state = {k: to_jax_tree(cfg, state[k]) for k in ("m", "v")}
    else:
        port_state = {k: to_jax_tree(cfg, state[k], stacked=True)
                      for k in ("vr", "vc")}
    return (to_jax_tree(cfg, params), port_state), (jp, js)


def _max_rel(got, want) -> float:
    got, want = jax.tree.leaves(_np_tree(got)), jax.tree.leaves(_np_tree(want))
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(a) - b).max()
                     / max(np.abs(b).max(), 1e-30)) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", OPT_ARCHS)
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_match_jax(opt_models, rng, kind, arch):
    cfg, jparams, named = opt_models[arch]
    port, ref = _two_steps(cfg, jparams, named, kind,
                           stacked_leaves(cfg, named), rng)
    assert jax.tree.structure(_np_tree(port)) == \
        jax.tree.structure(_np_tree(ref))
    assert _max_rel(port, ref) <= OPT_RTOL


@pytest.mark.parametrize("arch", OPT_ARCHS)
def test_adafactor_per_layer_would_differ(opt_models, rng, arch):
    """Trap of the reference's stacked leaves: Adafactor run per layer
    (each tensor its own leaf) is a different function, far outside the
    tolerance the grouped one meets."""
    cfg, jparams, named = opt_models[arch]
    (port_p, _), (ref_p, _) = _two_steps(cfg, jparams, named, "adafactor",
                                         None, rng)
    assert _max_rel(port_p, ref_p) > 1e3 * OPT_RTOL


def test_adafactor_factors_stacked_vectors():
    """A per-layer norm scale [d] is a slice of the stacked [n_groups, d]
    leaf, so its second moment is factored into [n_groups] and [d]."""
    cfg = get_config("smollm-135m").reduced()
    model = api.init_params(cfg, seed=0, device="cpu")
    named = {k: p.detach() for k, p in model.named_parameters()}
    st = init_opt_state(named, OptConfig(kind="adafactor"),
                        stacked_leaves(cfg, named))
    assert st["vr"]["blocks.0.norm1.scale"].shape == (2,)
    assert st["vc"]["blocks.0.norm1.scale"].shape == (64,)
    assert st["vr"]["blocks.0.mixer.q.w"].shape == (2, 64)
    assert st["vr"]["final_norm.scale"].shape == (64,)
    assert "blocks.1.mixer.q.w" not in st["vr"]


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(kind):
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 32)).astype(np.float32))
    params = {"w": torch.zeros((16, 32))}
    cfg = OptConfig(kind=kind, lr=0.05, weight_decay=0.0)
    state = init_opt_state(params, cfg)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    l0 = float(loss(params))
    for step in range(60):
        w = params["w"].clone().requires_grad_(True)
        g = torch.autograd.grad(loss({"w": w}), w)[0]
        params, state = apply_updates(params, {"w": g}, state,
                                      float(step + 1), cfg)
    assert float(loss(params)) < 0.2 * l0


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((64, 128)), "b": torch.zeros((128,))}
    st = init_opt_state(params, OptConfig(kind="adafactor"))
    assert st["vr"]["w"].shape == (64,)
    assert st["vc"]["w"].shape == (128,)
    assert st["vr"]["b"].shape == (128,)   # vectors keep full second moment
    adam = init_opt_state(params, OptConfig(kind="adamw"))
    n_adam = sum(x.numel() for d in adam.values() for x in d.values())
    n_af = sum(x.numel() for d in st.values() for x in d.values())
    assert n_af < n_adam / 20


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def smollm():
    cfg, jcfg, jparams, _ = _converted("smollm-135m")
    return cfg, jcfg, jparams


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("micro", [1, 4])
def test_train_step_matches_jax(smollm, kind, micro):
    """Three steps from the same weights on the launcher's batches: loss
    and grad_norm against the reference's jitted step."""
    cfg, jcfg, jparams = smollm
    tcfg = TrainConfig(opt=OptConfig(kind=kind, lr=1e-3), microbatches=micro)
    jtcfg = JaxTrainConfig(opt=JaxOptConfig(kind=kind, lr=1e-3),
                           microbatches=micro)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(_np_tree(jparams)))
    model.requires_grad_(True)
    named = {k: p.detach() for k, p in model.named_parameters()}
    opt = init_opt_state(named, tcfg.opt, stacked_leaves(cfg, named))
    jp, jopt = jparams, jax_init_opt_state(jparams, jtcfg.opt)
    step_fn = make_train_step(cfg, None, tcfg)
    jstep = jax.jit(jax_make_train_step(jcfg, None, jtcfg))
    base = token_base(cfg, 4, 16)
    for step in range(3):
        batch = batch_at(base, step, "cpu")
        model, opt, m = step_fn(model, opt, batch, step)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v.numpy())
                                        for k, v in batch.items()},
                             jnp.asarray(step, jnp.int32))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-4)
    tree = train_state_tree(cfg, model, opt)
    assert jax.tree.structure(_np_tree(tree)) == \
        jax.tree.structure(_np_tree((jp, jopt)))


def test_microbatch_equals_fullbatch():
    cfg = get_config("smollm-135m").reduced()
    out = []
    for micro in (1, 4):
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3), microbatches=micro)
        params, opt = init_training(cfg, 0, tcfg, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (8, 16)).astype(np.int32))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
                 "mask": torch.ones((8, 16))}
        params, _, m = make_train_step(cfg, None, tcfg)(params, opt, batch, 0)
        out.append((float(m["loss"]), [p.detach().clone()
                                        for p in params.parameters()]))
    assert out[0][0] == pytest.approx(out[1][0], rel=2e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-4)


def test_training_loss_decreases():
    """The reference's end-to-end invariant (``test_system.py``): 40 steps
    on a tiny corpus halve the loss."""
    cfg = get_config("smollm-135m").reduced(n_layers=2)
    tcfg = TrainConfig(opt=OptConfig(kind="adamw", lr=3e-3))
    params, opt_state = init_training(cfg, 0, tcfg, device="cpu")
    step_fn = make_train_step(cfg, None, tcfg)
    base = np.random.default_rng(0).integers(2, cfg.vocab_size, size=32)
    losses = []
    for step in range(40):
        toks = torch.from_numpy(np.stack([np.roll(base, i % 4)
                                          for i in range(4)]))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
                 "mask": torch.ones(toks.shape)}
        params, opt_state, m = step_fn(params, opt_state, batch, step)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_init_training_makes_only_its_params_trainable():
    cfg = get_config("smollm-135m").reduced()
    params, _ = init_training(cfg, 0, TrainConfig(), device="cpu")
    assert all(p.requires_grad for p in params.parameters())
    served = api.init_params(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
