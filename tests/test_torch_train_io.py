"""Around the port's trainer, against the JAX package on the CPU:
checkpoints (the reference's tests, and each package reading the other's),
the data pipeline's arrays, the elastic restart, ElasticTopology and the
gradient compression, and the train CLI (its lines and its flags)."""
import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.distributed import ElasticTopology as JaxElasticTopology
from repro.launch import train as jax_train
from repro.models import api as jax_api
from repro.training import OptConfig as JaxOptConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import grad_compress as jax_gc
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (ByteTokenizer, PackedDataset,
                                       ShardedLoader)
from repro_torch.distributed import ElasticTopology, HeartbeatTracker
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.params import from_jax_params, stacked_leaves
from repro_torch.training import (OptConfig, TrainConfig, init_opt_state,
                                  init_training, load_train_state,
                                  make_train_step, train_state_tree)
from repro_torch.training.grad_compress import (dequantize_int8,
                                                quantize_int8, topk_densify,
                                                topk_sparsify)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run thousands of small torch ops; under the parallel
    test run the workers' intra-op thread pools oversubscribe the cores and
    slow them ~70x.  One thread per worker here, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn(8, 16, generator=g) * scale},
            "b": [torch.randn(4, generator=g) * scale,
                  torch.arange(6, dtype=torch.int32)]}


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------ checkpoints

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(0)
    mgr.save(7, tree)
    restored, step = mgr.restore(tree)
    assert step == 7
    for a, b in zip(_leaves(tree), _leaves(restored)):
        np.testing.assert_array_equal(a, b)
    assert restored["b"][1].dtype == torch.int32


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(1)
    saved = tree["a"]["w"].clone()
    mgr.save(1, tree, blocking=False)
    tree["a"]["w"].add_(1.0)           # the snapshot was taken at save
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["a"]["w"], saved)


def test_atomicity_partial_write_ignored(tmp_path):
    """A half-written tmp dir (crash simulation) must never be visible."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree(2)
    mgr.save(3, tree)
    fake = tmp_path / ".tmp_step_0000000004"
    fake.mkdir()
    (fake / "a__w.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 3
    _, step = mgr.restore(tree)
    assert step == 3


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree(3)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros((8, 4))})


def test_restore_places_leaves_on_the_device(tmp_path):
    """``device=`` takes the place of the reference's ``shardings=``; the
    template's dtype wins."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, {"w": np.ones((8, 8), np.float32)})
    restored, _ = mgr.restore({"w": torch.zeros((8, 8), dtype=torch.float64)},
                              device="cpu")
    assert restored["w"].device.type == "cpu"
    assert restored["w"].dtype == torch.float64


def test_same_files_and_manifest_as_the_reference(tmp_path):
    tree = {"z": np.arange(3, dtype=np.float32),
            "a": [np.ones((2, 2), np.float32), np.zeros(4, np.int32)]}
    CheckpointManager(tmp_path / "port").save(2, tree)
    JaxCheckpointManager(tmp_path / "jax").save(2, tree)
    port, ref = (tmp_path / d / "step_0000000002" for d in ("port", "jax"))
    assert sorted(p.name for p in port.iterdir()) == \
        sorted(p.name for p in ref.iterdir())
    assert (port / "manifest.json").read_text() == \
        (ref / "manifest.json").read_text()


def test_bf16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    """The reference saves bf16 as raw 2-byte voids and cannot read them
    back; the port writes the same bytes and reads them back exactly."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    CheckpointManager(tmp_path / "port").save(1, {"x": x})
    JaxCheckpointManager(tmp_path / "jax").save(
        1, {"x": jnp.asarray(x.float().numpy(), jnp.bfloat16)})
    files = [tmp_path / d / "step_0000000001" / "x.npy" for d in ("port", "jax")]
    assert files[0].read_bytes() == files[1].read_bytes()
    for d in ("port", "jax"):
        back, _ = CheckpointManager(tmp_path / d).restore({"x": x})
        assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)
    with pytest.raises(ValueError):
        JaxCheckpointManager(tmp_path / "port").restore(
            {"x": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16)})


# ------------------------------------- checkpoints across the two packages

def _jax_trained(kind: str, steps: int = 2):
    """The reference's reduced smollm after ``steps`` steps of its
    launcher's batches: (JAX cfg, params, opt_state)."""
    jcfg = jax_get_config("smollm-135m").reduced()
    jtcfg = JaxTrainConfig(opt=JaxOptConfig(kind=kind, lr=1e-3))
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    opt = jax_init_opt_state(params, jtcfg.opt)
    step_fn = jax.jit(jax_make_train_step(jcfg, None, jtcfg))
    base = train.token_base(jcfg, 4, 16)
    for step in range(steps):
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in train.batch_at(base, step, "cpu").items()}
        params, opt, _ = step_fn(params, opt, batch,
                                 jnp.asarray(step, jnp.int32))
    return jcfg, params, opt


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, kind):
    _, jparams, jopt = _jax_trained(kind)
    JaxCheckpointManager(tmp_path).save(2, (jparams, jopt))
    cfg = get_config("smollm-135m").reduced()
    tcfg = TrainConfig(opt=OptConfig(kind=kind, lr=1e-3))
    params, opt = init_training(cfg, 0, tcfg, device="cpu")
    tree, step = CheckpointManager(tmp_path).restore(
        train_state_tree(cfg, params, opt))
    opt = load_train_state(params, tree)
    assert step == 2
    ported = train_state_tree(cfg, params, opt)
    assert jax.tree.structure(jax.tree.map(np.asarray, ported)) == \
        jax.tree.structure(jax.tree.map(np.asarray, (jparams, jopt)))
    for a, b in zip(_leaves(ported), _leaves((jparams, jopt))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, kind):
    jcfg, jparams, jopt = _jax_trained(kind, steps=0)
    cfg = get_config("smollm-135m").reduced()
    tcfg = TrainConfig(opt=OptConfig(kind=kind, lr=1e-3))
    params, opt = init_training(cfg, 0, tcfg, device="cpu")
    step_fn = make_train_step(cfg, None, tcfg)
    base = train.token_base(cfg, 4, 16)
    for step in range(2):
        params, opt, _ = step_fn(params, opt, train.batch_at(base, step, "cpu"),
                                 step)
    CheckpointManager(tmp_path).save(2, train_state_tree(cfg, params, opt))
    tmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        (jparams, jopt))
    (rp, ropt), step = JaxCheckpointManager(tmp_path).restore(tmpl)
    assert step == 2
    for a, b in zip(_leaves((rp, ropt)),
                    _leaves(train_state_tree(cfg, params, opt))):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- data pipeline

DOCS = ["the quick brown fox", "jumps over", "the lazy dog " * 5,
        "pack my box with five dozen liquor jugs"] * 4


def test_tokenizer_roundtrip():
    tok = ByteTokenizer()
    ids = tok.encode("hello world")
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert tok.decode(ids) == "hello world"
    assert ids == jax_pipeline.ByteTokenizer().encode("hello world")


def test_packing_shapes_and_mask():
    ds = PackedDataset.from_documents(DOCS, seq_len=32)
    assert ds.rows.shape[1] == 33
    assert ds.boundary_mask.shape == (len(ds), 32)
    labels = ds.rows[:, 1:]
    assert ((ds.boundary_mask == 0) == (labels == ByteTokenizer.bos_id)).all()
    ref = jax_pipeline.PackedDataset.from_documents(DOCS, seq_len=32)
    np.testing.assert_array_equal(ds.rows, ref.rows)
    np.testing.assert_array_equal(ds.boundary_mask, ref.boundary_mask)


def test_loader_determinism_and_restart():
    ds = PackedDataset.from_documents(DOCS, seq_len=32)
    b5a = ShardedLoader(ds, global_batch=4, seed=7).batch_at(5)
    b5b = ShardedLoader(ds, global_batch=4, seed=7).batch_at(5)   # "restart"
    np.testing.assert_array_equal(b5a["tokens"], b5b["tokens"])
    ref = jax_pipeline.ShardedLoader(
        jax_pipeline.PackedDataset.from_documents(DOCS, seq_len=32),
        global_batch=4, seed=7)
    for step in range(12):
        mine, theirs = ShardedLoader(ds, global_batch=4, seed=7) \
            .batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels", "mask"):
            np.testing.assert_array_equal(mine[k], theirs[k])


def test_loader_host_sharding_partitions_batch():
    ds = PackedDataset.from_documents(DOCS, seq_len=32)
    full = ShardedLoader(ds, global_batch=4, seed=0).batch_at(3)["tokens"]
    parts = [ShardedLoader(ds, global_batch=4, host_id=h, n_hosts=2,
                           seed=0).batch_at(3)["tokens"] for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


# ---------------------------------------------------- restart and compress

RESTART_DOCS = ["elastic restart with node loss keeps the stream "
                "deterministic"] * 24


def test_train_failover_resume(tmp_path):
    """Train, checkpoint at step 4, lose a host, plan the smaller mesh,
    restore into fresh tensors and recompute steps 4-5 (within 1e-5)."""
    cfg = get_config("smollm-135m").reduced(n_layers=2)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
    params, opt = init_training(cfg, 0, tcfg, device="cpu")
    step_fn = make_train_step(cfg, None, tcfg)
    loader = ShardedLoader(PackedDataset.from_documents(RESTART_DOCS,
                                                        seq_len=24),
                           global_batch=4, seed=0)
    mgr = CheckpointManager(tmp_path, keep=2)

    def to_batch(b):
        return {k: torch.from_numpy(v % cfg.vocab_size if k != "mask" else v)
                for k, v in b.items()}

    losses = []
    for step in range(6):
        params, opt, m = step_fn(params, opt, to_batch(loader.batch_at(step)),
                                 step)
        losses.append(float(m["loss"]))
        if step == 3:
            mgr.save(4, train_state_tree(cfg, params, opt))

    hb = HeartbeatTracker(timeout=5.0)
    for h in range(8):
        hb.beat(h, now=0.0)
    for h in range(8):
        if h != 3:
            hb.beat(h, now=10.0)
    assert hb.failed(now=12.0) == [3]
    plan = ElasticTopology(pods=2, hosts_per_pod=4).plan_after_failures(
        set(hb.failed(now=12.0)))
    assert plan["pods"] == [1]

    fresh, fresh_opt = init_training(cfg, 1, tcfg, device="cpu")
    tree, start = mgr.restore(train_state_tree(cfg, fresh, fresh_opt))
    fresh_opt = load_train_state(fresh, tree)
    assert start == 4
    relosses = []
    for step in range(start, 6):
        fresh, fresh_opt, m = step_fn(fresh, fresh_opt,
                                      to_batch(loader.batch_at(step)), step)
        relosses.append(float(m["loss"]))
    np.testing.assert_allclose(relosses, losses[4:6], rtol=1e-5)


@pytest.mark.parametrize("failed", [{70}, {3, 70}, set()])
def test_elastic_topology_matches_jax(failed):
    mine = ElasticTopology(pods=2, hosts_per_pod=64).plan_after_failures(failed)
    theirs = JaxElasticTopology(pods=2, hosts_per_pod=64) \
        .plan_after_failures(failed)
    assert mine == theirs
    if failed == {70}:
        assert mine["pods"] == [0] and mine["mesh_shape"] == (1, 16, 16)
    if failed == {3, 70}:
        assert mine["degraded"] and mine["mesh_shape"][1] < 16


def test_int8_grad_compression_error():
    g = (np.random.default_rng(0).standard_normal((256, 256)) * 0.01) \
        .astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(g))
    g2 = dequantize_int8(q, s).numpy()
    assert np.abs(g2 - g).mean() / np.abs(g).mean() < 0.03
    assert q.dtype == torch.int8
    jq, js = jax_gc.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)


def test_topk_sparsify_roundtrip():
    g = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)
    payload, residual = topk_sparsify(torch.from_numpy(g), frac=0.1)
    dense = topk_densify(payload).numpy()
    np.testing.assert_allclose(dense + residual.numpy(), g, atol=1e-6)
    assert (dense != 0).sum() <= int(g.size * 0.1) + 1
    jpayload, jresidual = jax_gc.topk_sparsify(jnp.asarray(g), frac=0.1)
    np.testing.assert_array_equal(dense, np.asarray(jax_gc.topk_densify(jpayload)))
    np.testing.assert_array_equal(residual.numpy(), np.asarray(jresidual))


# ------------------------------------------------------------- the train CLI

def _lines(main, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def _jax_main(argv):
    old = sys.argv
    sys.argv = ["train", *argv]
    try:
        jax_train.main()
    finally:
        sys.argv = old


def test_train_cli_lines_match_the_reference():
    """``--steps 3``: the same plan line, loss lines at the same steps (the
    weights differ: each package draws its own from seed 0), the closing
    line; both losses start near ln(vocab) and fall."""
    mine = _lines(train.main, ["--device", "cpu", "--steps", "3"])
    theirs = _lines(_jax_main, ["--steps", "3"])
    assert mine[0] == theirs[0]
    assert mine[0].startswith("production plan for smollm-135m: ")
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine[1:3], theirs[1:3]):
        assert a.split()[:2] == b.split()[:2] and a.split()[2] == "loss"
        assert float(a.split()[3]) == pytest.approx(float(b.split()[3]),
                                                    rel=0.05)
    assert [ln.split()[0] for ln in mine[1:3]] == ["step"] * 2
    assert mine[3].startswith("3 steps in ") and theirs[3].startswith(
        "3 steps in ")


def test_train_cli_returns_every_loss_and_saves_checkpoints(tmp_path):
    out = train.main(["--device", "cpu", "--steps", "21", "--optimizer",
                      "adafactor", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 21 and out["losses"][-1] < out["losses"][0]
    mgr = CheckpointManager(tmp_path)
    assert mgr.all_steps() == [20]
    cfg = out["cfg"]
    params, opt = init_training(cfg, 1, TrainConfig(
        opt=OptConfig(kind="adafactor", lr=1e-3)), device="cpu")
    tree, _ = mgr.restore(train_state_tree(cfg, params, opt))
    opt = load_train_state(params, tree)
    step_fn = make_train_step(cfg, None, TrainConfig(
        opt=OptConfig(kind="adafactor", lr=1e-3)))
    _, _, m = step_fn(params, opt, train.batch_at(
        train.token_base(cfg, 4, 64), 20, "cpu"), 20)
    assert float(m["loss"]) == pytest.approx(out["losses"][20], rel=1e-5)


def test_train_parsers_differ_only_by_device_and_no_reduced():
    class Parsed(Exception):
        pass

    def grab(ap, args=None):
        raise Parsed(ap)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train.argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Parsed) as caught:
        jax_train.main()
    mp.undo()
    ref = {a.dest: (a.option_strings, a.default)
           for a in caught.value.args[0]._actions}
    mine = {a.dest: (a.option_strings, a.default)
            for a in train.build_parser()._actions}
    assert mine.pop("device") == (["--device"], "cuda")
    assert mine.pop("reduced") == (["--reduced", "--no-reduced"], True)
    assert ref.pop("reduced") == (["--reduced"], True)
    assert mine == ref


def test_train_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])


def test_stacked_leaves_follow_the_group_period():
    cfg = get_config("gemma2-27b").reduced(n_layers=4)
    model = api.init_params(cfg, seed=0, device="cpu")
    stacks = stacked_leaves(cfg, dict(model.named_parameters()))
    assert stacks["blocks.0.mixer.q.w"] == ["blocks.0.mixer.q.w",
                                            "blocks.2.mixer.q.w"]
    assert stacks["blocks.1.norm1.scale"] == ["blocks.1.norm1.scale",
                                              "blocks.3.norm1.scale"]
    assert "embed.w" not in stacks
    st = init_opt_state({k: p.detach() for k, p in model.named_parameters()},
                        OptConfig(kind="adafactor"), stacks)
    assert st["vr"]["blocks.1.norm1.scale"].shape == (2,)
    assert from_jax_params(jax.tree.map(np.asarray, jax_api.init_params(
        jax_get_config("gemma2-27b").reduced(n_layers=4),
        jax.random.PRNGKey(0), jnp.float32))).keys() == \
        model.state_dict().keys()
