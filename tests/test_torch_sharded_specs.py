"""The port's sharding layer on the host: ``param_specs`` and
``cache_specs_tree`` against the JAX package's for every arch, reduced and
full, under every plan ``candidate_plans`` builds (train, prefill and
decode shapes), on {data: 2, model: 2}, {data: 1, model: 4} and {data: 16,
model: 16}; the flash-decoding partial and its merge against the JAX
package's; the mesh's rank order and collectives on 4 gloo ranks, and the
backend it picks from where the ranks compute; the optimizer state's
specs under every train plan; and the places a plan raises, as the
reference does or until a later slice; batch-only paged decode."""
import dataclasses
import functools
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.core import deployer as jax_deployer
from repro.kernels.decode_attention import xla as jax_decode
from repro.core.types import Request as JaxRequest
from repro.models import api as jax_api
from repro.serving import PagedEngine as JaxPagedEngine
from repro.serving import PagedEngineConfig as JaxPagedEngineConfig
from repro.sharding.plan import ShardingPlan as JaxShardingPlan
from repro.sharding import specs as jax_specs
from repro.training import OptConfig as JaxOptConfig
from repro.training import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core.types import Request
from repro_torch.distributed.ranks import run_ranks
from repro_torch.kernels.decode_attention import (combine_partials,
                                                  decode_attention_partial)
from repro_torch.kernels.decode_attention.partial import NEG_INF
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.models import api
from repro_torch.models import attention
from repro_torch.serving import PagedEngine, PagedEngineConfig
from repro_torch.sharding import ShardingPlan
from repro_torch.sharding import specs
from repro_torch.sharding.mesh import (axis_size, choose_backend, divisible,
                                       placement)
from repro_torch.params import stacked_leaves
from repro_torch.training import (OptConfig, TrainConfig, make_train_step,
                                  opt_state_specs)

import torch_sharded_port

ARCHS = list_archs(include_extra=True)
MESHES = [{"data": 2, "model": 2}, {"data": 1, "model": 4},
          {"data": 16, "model": 16}]


def _plans(jcfg):
    """Every distinct plan of ``candidate_plans`` over the four shapes."""
    seen = []
    for shape in JAX_SHAPES.values():
        for mp in jax_deployer.candidate_plans(jcfg, shape, multi_pod=False):
            if mp.plan not in seen:
                seen.append(mp.plan)
    return seen


def _port_plan(jplan) -> ShardingPlan:
    return ShardingPlan(**dataclasses.asdict(jplan))


def _leaves(tree):
    """(path tuple, leaf) of a nested dict of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(tuple(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def _port_names(path, shape, period):
    """Port names of the layers of one reference leaf: each group's slice
    of a decoder's stacked leaf, each layer of an encoder-decoder stack."""
    top = path[0]
    if top == "blocks":
        i = int(path[1][1:])
        return [f"blocks.{g * period + i}." + ".".join(path[2:])
                for g in range(shape[0])]
    if top in ("enc_blocks", "dec_blocks"):
        return [f"{top}.{j}." + ".".join(path[1:]) for j in range(shape[0])]
    return [".".join(path)]


@functools.cache
def _arch(arch, reduced):
    """(JAX cfg, port cfg, the reference's parameter structure, its
    caches' structures at three (batch, length), the plans): once an arch,
    shared by the three meshes' tests."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    caches = [jax_api.cache_specs(jcfg, b, s)
              for b, s in ((4, 20), (2, 18), (128, 32768))]
    return (jcfg, cfg, jax_api.param_specs_struct(jcfg, jnp.float32), caches,
            _plans(jcfg))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m['data']}x{m['model']}")
def test_param_and_cache_specs_equal_the_reference(arch, mesh):
    for reduced in (True, False):
        jcfg, cfg, struct, caches, plans = _arch(arch, reduced)
        period = len(struct.get("blocks", {})) or 1
        structs = dict(_leaves(struct))
        for jplan in plans:
            plan = _port_plan(jplan)
            ref = jax_specs.param_specs(jcfg, jplan, struct, mesh)
            for path, pspec in _leaves(ref):
                shape = structs[path].shape
                stacked = path[0] in ("blocks", "enc_blocks", "dec_blocks")
                want = tuple(pspec)[1:] if stacked else tuple(pspec)
                body = shape[1:] if stacked else shape
                for name in _port_names(path, shape, period)[:2]:
                    assert specs.param_spec(cfg, plan, name, body, mesh) == want, \
                        (arch, reduced, jplan, name)
            for cstruct in caches:
                cref = jax_specs.cache_specs_tree(jcfg, jplan, cstruct, mesh)
                shapes = dict(_leaves(cstruct))
                for path, cspec in _leaves(cref):
                    body = shapes[path].shape[1:]
                    assert specs.cache_spec(cfg, plan, path[-1], body, mesh) \
                        == tuple(cspec)[1:], (arch, reduced, jplan, path)


@pytest.mark.parametrize("arch", ["chatglm2-6b", "minicpm3-4b", "rwkv6-3b",
                                  "whisper-medium"])
def test_specs_cover_the_port_tree(arch):
    """The names ``param_specs`` reads are the port's own: a reduced
    model's state dict; ``cache_specs_tree`` walks the port's cache list."""
    cfg = get_config(arch).reduced()
    plan = ShardingPlan(batch_axes=("data",), model_axis="model",
                        seq_axes=("model",))
    mesh = {"data": 2, "model": 2}
    model = api.init_params(cfg, device="cpu")
    got = specs.param_specs(cfg, plan, model.state_dict(), mesh)
    assert set(got) == set(model.state_dict())
    assert got["embed.w"] == ("model", None)
    assert specs.param_specs(cfg, None, model.state_dict(), mesh)["embed.w"] == ()
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.long)}
    if cfg.is_encdec:
        batch["frames"] = torch.zeros((2, 8, cfg.d_model))
    _, cache = api.prefill(cfg, model, batch, cache_len=8)
    tree = specs.cache_specs_tree(cfg, plan, cache, mesh)
    assert len(tree) == cfg.n_layers
    flat = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, tuple))
    assert flat and all(isinstance(s, tuple) and s[0] == "data" for s in flat)


def test_production_mesh_shape():
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert list(make_production_mesh(multi_pod=True)) == ["pod", "data", "model"]
    assert mesh_shape_dict(make_production_mesh()) == {"data": 16, "model": 16}


@pytest.mark.parametrize("window", [None, 5])
def test_partial_and_combine_equal_the_reference(window):
    """Four shards of a 24-row cache (one holding no valid row of the
    second sequence), each with its offset and, with a window, the
    absolute low cutoff, against the JAX package's XLA primitives."""
    rng = np.random.default_rng(3)
    b, s, h, kv, d, n = 2, 24, 4, 2, 8, 4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    kv_len = np.array([21, 9], np.int32)
    s_loc = s // n
    parts, jparts = [], []
    for i in range(n):
        sl = slice(i * s_loc, (i + 1) * s_loc)
        local = np.clip(kv_len - i * s_loc, 0, s_loc).astype(np.int32)
        lo = np.maximum(kv_len - window, 0) if window else None
        got = decode_attention_partial(
            torch.as_tensor(q), torch.as_tensor(k[:, sl]), torch.as_tensor(v[:, sl]),
            torch.as_tensor(local), window_lo=None if lo is None else torch.as_tensor(lo),
            pos_offset=i * s_loc, softcap=30.0)
        ref = jax_decode.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(local), window_lo=None if lo is None else jnp.asarray(lo),
            pos_offset=i * s_loc, softcap=30.0)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6)
        parts.append(got)
        jparts.append(ref)
    # the second sequence's 9 rows end in shard 1: shards 2 and 3 are empty
    for i in (2, 3):
        acc, m, l = parts[i]
        assert torch.all(m[1] == NEG_INF) and torch.all(l[1] == 0)
        assert torch.isfinite(acc).all()
    got = combine_partials(*(torch.stack([p[j] for p in parts]) for j in range(3)),
                           stack_dim=0)
    ref = jax_decode.combine_partials(
        *(jnp.stack([p[j] for p in jparts]) for j in range(3)), stack_axis=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert torch.isfinite(got).all()


def test_run_ranks_reports_the_first_rank_that_raised(tmp_path):
    """When a rank raises and the others then fail on the lost peer, the
    parent's error names every failed rank, the rank that raised first
    with its own exception."""
    with pytest.raises(RuntimeError) as err:
        run_ranks(torch_sharded_port.failing_probe, (str(tmp_path),), world=4,
                  timeout=30.0, join_timeout=60.0)
    msg = str(err.value)
    assert "ranks failed (rank: exit code): {" in msg
    first = msg.split("}; ", 1)[1].split("; ")[0]
    assert first == "rank 2 (+0.00 s): ValueError: probe failure on rank 2"
    for r in (0, 1, 3):
        assert f"rank {r} (+" in msg


def test_mesh_rank_order_and_collectives(tmp_path):
    """Rank r sits at the row-major coordinates of JAX's device grid; a
    group gathers in that order over a single axis and over ("data",
    "model"); psum, pmax, the tiled all-to-all and reduce-scatter;
    ``shard_tree`` cuts this rank's block and ``gather_tree`` restores the
    whole."""
    run_ranks(torch_sharded_port.mesh_probe, (str(tmp_path),), world=4,
              timeout=60.0, join_timeout=120.0)
    seen = [json.loads((tmp_path / f"mesh{r}.json").read_text()) for r in range(4)]
    for key, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
        grid = np.arange(4).reshape(shape)
        for r in range(4):
            got = seen[r][key]
            assert got["backend"] == "gloo"           # CPU ranks
            di, mi = (int(c) for c in np.argwhere(grid == r)[0])
            assert got["coords"] == {"data": di, "model": mi}
            assert got["index"] == {"data": di if shape[0] > 1 else 0,
                                    "model": mi, "both": r}
            assert got["gather"]["model"] == [float(x) for x in grid[di]]
            assert got["gather"]["data"] == [float(x) for x in grid[:, mi]]
            assert got["gather"]["both"] == [float(x) for x in range(4)]
            assert got["psum"] == 6.0
            assert got["pmax"] == float(grid[di].max())
            assert got["to_all"] == [10.0 * j + r for j in range(4)]
            n = shape[1]
            full = np.arange(4.0) * sum(x + 1 for x in grid[di])
            assert got["scatter"] == full[mi * 4 // n:(mi + 1) * 4 // n].tolist()
            a = np.arange(32.0).reshape(4, 8)
            rows, cols = 4 // shape[0], 8 // shape[1]
            assert got["tree"]["a"] == a[di * rows:(di + 1) * rows,
                                         mi * cols:(mi + 1) * cols].tolist()
            assert got["tree"]["b"] == [2.0 * r, 2.0 * r + 1]
            assert got["round_trip"]


@pytest.mark.parametrize("places, backend", [
    ([("h", 0), ("h", 1), ("h", 2), ("h", 3)], "nccl"),   # a card each
    ([("h", 0)] * 4, "gloo"),                             # one shared card
    ([("h", 0), ("h", 1), ("h", 1), ("h", 2)], "gloo"),   # two share one
    ([("a", 0), ("a", 1), ("b", 0), ("b", 1)], "nccl"),   # two hosts
    ([("h", -1)] * 4, "gloo"),                            # CPU ranks
    ([("h", 0), ("h", -1)], "gloo"),                      # a CPU rank
])
def test_backend_follows_the_ranks_placement(places, backend):
    """NCCL only where every rank computes on a card of its own, however
    many cards the host shows."""
    assert choose_backend(places) == backend


def test_placement_of_a_rank():
    host = socket.gethostname()
    assert placement(torch.device("cpu")) == (host, -1)
    assert placement(torch.device("cuda", 2)) == (host, 2)


def test_one_size_rule_on_a_shape_and_the_current_mesh():
    """``axis_size`` / ``divisible`` on a shape dict; outside a mesh every
    axis has size 1, as the plan's sizes read the current mesh."""
    shape = {"data": 2, "model": 4}
    assert axis_size(("model", "data"), shape) == 8
    assert axis_size(("data", "pod"), shape) == axis_size("data", shape) == 2
    assert axis_size(None, shape) == axis_size((), shape) == 1
    assert divisible(8, "model", shape) and not divisible(6, "model", shape)
    assert not divisible(8, "pod", shape) and not divisible(8, None, shape)
    assert axis_size("model") == 1 and not divisible(8, "model")


TP_DP = ShardingPlan(batch_axes=("data",), model_axis="model",
                     seq_axes=("model",))


def test_plans_raise_where_the_reference_does():
    """Prefix continuation and paged decode under model or sequence axes
    raise with the reference's messages; paged decode under a batch-only
    plan runs, and without a mesh (every axis of size 1) it is the
    unsharded call, its pool write included."""
    cfg = get_config("smollm-135m").reduced()
    spec = cfg.layer_plan()[0]
    model = api.init_params(cfg, device="cpu")
    p = model.blocks[0].mixer
    x = torch.zeros((1, 2, cfg.d_model))
    prefix = {"k": torch.zeros((1, 2, cfg.n_kv_heads, cfg.head_dim_eff)),
              "v": torch.zeros((1, 2, cfg.n_kv_heads, cfg.head_dim_eff))}
    with pytest.raises(NotImplementedError, match="sharded plans not supported"):
        attention.attn_prefill(cfg, spec, p, x, positions=torch.zeros((1, 2)),
                               plan=TP_DP, prefix=prefix)
    pool = {"k": torch.zeros((2, 4, 1, 16)), "v": torch.zeros((2, 4, 1, 16))}
    kv_len = torch.zeros(1, dtype=torch.int32)
    tables = torch.zeros((1, 1), dtype=torch.int32)
    for plan in (TP_DP, ShardingPlan(seq_axes=("data",))):
        with pytest.raises(NotImplementedError, match="model/seq-sharded"):
            attention.attn_paged_decode(cfg, spec, p, x[:, :1], pool, tables,
                                        kv_len, plan=plan)
    xs = torch.randn((1, 1, cfg.d_model),
                     generator=torch.Generator().manual_seed(0))
    runs = []
    for plan in (None, ShardingPlan(batch_axes=("data",))):
        fresh = {n: t.clone() for n, t in pool.items()}
        y, out = attention.attn_paged_decode(cfg, spec, p, xs, fresh, tables,
                                             kv_len + 1, plan=plan)
        runs.append((y, out))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in ("k", "v"))
    assert runs[1][1]["k"].abs().sum() > 0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-3b",
                                  "whisper-medium"])
def test_recurrent_and_encdec_blocks_run_under_a_plan(arch):
    """Mamba and RWKV-6 blocks and encoder-decoder models run under a plan
    at every entry point: without a mesh every axis has size 1, so
    ``api.prefill``, ``api.decode_step`` and ``api.loss_fn`` under TP_DP
    are the unsharded functions, bit for bit
    (``test_torch_sharded_recurrent.py``, ``..._recurrent_train.py`` and
    ``..._encdec.py`` hold them on 4 ranks).  The reference's own raises
    stay: prefix continuation and the paged steps of an encoder-decoder."""
    cfg = get_config(arch).reduced()
    model = api.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.arange(8, dtype=torch.long).reshape(2, 4) + 2
    kv_len = torch.tensor([4, 3], dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((2, cfg.cross_kv_len, cfg.d_model),
                                      generator=gen) * 0.02
    lg, cache = api.prefill(cfg, model, batch, cache_len=8, kv_len=kv_len)
    got, got_cache = api.prefill(cfg, model, batch, cache_len=8,
                                 kv_len=kv_len, plan=TP_DP)
    assert torch.equal(got, lg)
    step = lg.argmax(-1)[:, None]
    want = api.decode_step(cfg, model, step, cache, kv_len)[0]
    assert torch.equal(api.decode_step(cfg, model, step, got_cache, kv_len,
                                       plan=TP_DP)[0], want)
    train = {**batch, "labels": toks.roll(-1, 1)}
    with torch.no_grad():
        assert torch.equal(api.loss_fn(cfg, model, train, plan=TP_DP)[0],
                           api.loss_fn(cfg, model, train)[0])
    if cfg.is_encdec:
        with pytest.raises(NotImplementedError, match="cross caches"):
            api.prefill(cfg, model, batch, cache_len=8, plan=TP_DP,
                        prefix_kv=[{"k": None}])
        with pytest.raises(NotImplementedError, match="cross caches"):
            api.paged_decode_step(cfg, model, step, None, None, kv_len,
                                  plan=TP_DP)


def test_training_paged_and_fsdp_raise_under_a_plan():
    """Training and an fsdp plan run (``test_torch_sharded_train.py`` holds
    them on 4 ranks); without a mesh every axis has size 1, so each is the
    unsharded function.  The paged engine under a plan with a model axis
    raises where the reference's does, with its exception type: the
    reference's at its first decode step (``NotImplementedError``), the
    port's before any device work (``test_torch_sharded_paged.py`` holds
    the batch-only plan on 4 ranks, and the other raises on a mesh)."""
    cfg = get_config("smollm-135m").reduced()
    model = api.init_params(cfg, device="cpu")
    toks = torch.arange(8, dtype=torch.long).reshape(2, 4) + 2
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    fsdp = ShardingPlan(batch_axes=("data",), model_axis="model",
                        fsdp_axes=("data",), seq_parallel=True, remat=True)
    with torch.no_grad():
        want = api.loss_fn(cfg, model, batch)[0]
        for plan in (TP_DP, fsdp):
            assert torch.equal(api.loss_fn(cfg, model, batch, plan=plan)[0],
                               want)
        lg = api.prefill(cfg, model, {"tokens": toks}, cache_len=8)[0]
        assert torch.equal(api.prefill(cfg, model, {"tokens": toks},
                                       cache_len=8, plan=fsdp)[0], lg)
    assert callable(make_train_step(cfg, TP_DP, TrainConfig()))
    reqs = [Request(rid=0, tokens=[3, 4, 5], input_len=3, slo=1e9,
                    arrival=0.0, true_output_len=4)]
    pcfg = dict(max_batch=2, block_size=8, n_blocks=8, max_seq_len=32,
                max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="model/seq-sharded") as err:
        PagedEngine(cfg, model, PagedEngineConfig(**pcfg),
                    plan=TP_DP).run_continuous(reqs)
    jcfg = jax_get_config("smollm-135m").reduced()
    jplan = JaxShardingPlan(batch_axes=("data",), model_axis="model",
                            seq_axes=("model",))
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    with pytest.raises(NotImplementedError, match="model/seq-sharded") as jerr:
        JaxPagedEngine(jcfg, jparams, JaxPagedEngineConfig(**pcfg),
                       plan=jplan).run_continuous(
            [JaxRequest(rid=0, tokens=[3, 4, 5], input_len=3, slo=1e9,
                        arrival=0.0, true_output_len=4)])
    assert type(err.value) is type(jerr.value)


def _train_plans(jcfg):
    return [p for p in _plans(jcfg) if p.remat]


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_the_reference(arch):
    """AdamW's and Adafactor's state specs on the port's names (a stacked
    leaf's factors under its ``stacked_leaves`` key) against the
    reference's ``opt_state_specs`` of its ``param_specs``, for every train
    plan of ``candidate_plans`` on the three meshes, reduced and full."""
    for reduced in (True, False):
        jcfg, cfg, struct, _, plans = _arch(arch, reduced)
        period = len(struct.get("blocks", {})) or 1
        leaves = _leaves(struct)
        for mesh in MESHES:
            for jplan in _train_plans(jcfg):
                plan = _port_plan(jplan)
                ref_specs = jax_specs.param_specs(jcfg, jplan, struct, mesh)
                port = {}
                for path, leaf in leaves:
                    stacked = path[0] in ("blocks", "enc_blocks", "dec_blocks")
                    body = leaf.shape[1:] if stacked else leaf.shape
                    for name in _port_names(path, leaf.shape, period):
                        port[name] = specs.param_spec(cfg, plan, name, body, mesh)
                stacks = stacked_leaves(cfg, port)
                for kind in ("adamw", "adafactor"):
                    ref = jax_opt.opt_state_specs(ref_specs,
                                                  JaxOptConfig(kind=kind))
                    got = opt_state_specs(port, OptConfig(kind=kind), stacks)
                    assert set(got) == set(ref)
                    for part, tree in ref.items():
                        want = {}
                        for path, spec in _leaves(tree):
                            stacked = path[0] in ("blocks", "enc_blocks",
                                                  "dec_blocks")
                            if kind == "adafactor" or not stacked:
                                key = _state_key(path)
                                want[key] = tuple(spec)
                            else:
                                for name in _port_names(
                                        path, dict(leaves)[path].shape, period):
                                    want[name] = tuple(spec)[1:]
                        assert got[part] == want, (arch, reduced, jplan, kind,
                                                   part)


def _state_key(path) -> str:
    """The port's key of a reference leaf: its ``stacked_leaves`` key in a
    stack, its name elsewhere."""
    top = path[0]
    if top == "blocks":
        return f"blocks.{path[1][1:]}." + ".".join(path[2:])
    if top in ("enc_blocks", "dec_blocks"):
        return f"{top}.0." + ".".join(path[1:])
    return ".".join(path)
