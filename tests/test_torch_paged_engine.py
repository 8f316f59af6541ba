"""The port's paged serving path against the JAX package on the CPU: the
block allocator, the prefix cache and the n-gram drafter step for step on
the same call sequences; the paged engine token for token (and counter for
counter) in the scenarios of the JAX package's engine tests — plain,
backpressure, lookahead, chunked, preemption, n-gram and model speculation,
prefix sharing with copy-on-write, eviction, abort and resume — on
converted weights at the reduced smollm-135m size; and the ``--paged``
serve CLI, whose digest equals the JAX serve's and the padded path's."""
import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import profiler as jax_profiler
from repro.core.types import Request as JaxRequest
from repro.data import workload as jax_workload
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.obs.trace import Tracer as JaxTracer
from repro.serving import ModelDrafter as JaxModelDrafter
from repro.serving import PagedEngine as JaxPagedEngine
from repro.serving import PagedEngineConfig as JaxPagedEngineConfig
from repro.serving.kv_cache import BlockAllocator as JaxBlockAllocator
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro.serving.speculative import NGramDrafter as JaxNGramDrafter
from repro_torch.configs import get_config
from repro_torch.core import profiler
from repro_torch.core.types import Request
from repro_torch.data import workload
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.obs.trace import Tracer
from repro_torch.params import from_jax_params, predictor_from_numpy
from repro_torch.serving import (BlockAllocator, ModelDrafter, NGramDrafter,
                                 PagedEngine, PagedEngineConfig, PagedKVCache,
                                 PagedKVConfig, PrefixCache, kv_block_bytes)

BS = 8
VOCAB = 512                      # the reduced config's vocab
# PagedBatchResult fields that read the wall clock
CLOCKED = {"prefill_s", "decode_s", "prefill_stall_s", "inter_token_s"}


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port model with the JAX weights)."""
    jcfg = jax_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tmodel = api.init_params(cfg, seed=0, device="cpu")
    tmodel.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, tmodel


# ------------------------------------------------- host-side state machines

def _alloc_state(a):
    return (list(a.free), {k: list(v) for k, v in a.tables.items()},
            dict(a.refcnt), set(a.retained), set(a.cached))


def test_block_allocator_matches_jax_step_for_step():
    """A seeded random sequence of alloc / share / cow / truncate / retain
    / release_cached / free_seq calls leaves both allocators in the same
    state after every call, with the same results and the same errors."""
    rng = np.random.default_rng(4)
    mine, ref = BlockAllocator(12), JaxBlockAllocator(12)
    for step in range(400):
        op = rng.integers(7)
        seq = int(rng.integers(4))
        live = sorted({b for t in ref.tables.values() for b in t})
        if op == 0:
            args = ("alloc", seq, int(rng.integers(1, 4)))
        elif op == 1 and live:
            args = ("share", seq, [int(rng.choice(live))])
        elif op == 2 and ref.tables.get(seq):
            args = ("cow", seq, int(rng.choice(ref.tables[seq])))
        elif op == 3:
            args = ("truncate", seq, int(rng.integers(3)))
        elif op == 4 and live:
            args = ("retain", int(rng.choice(live)))
        elif op == 5 and ref.cached:
            args = ("release_cached", int(rng.choice(sorted(ref.cached))))
        else:
            args = ("free_seq", seq)
        outs = []
        for a in (mine, ref):
            try:
                outs.append(getattr(a, args[0])(*args[1:]))
            except MemoryError as e:
                outs.append(f"MemoryError: {e}")
        assert outs[0] == outs[1], (step, args)
        assert _alloc_state(mine) == _alloc_state(ref), (step, args)
        assert mine.stats() == ref.stats() and mine.available == ref.available
        assert mine.check() == ref.check() == []


def _match_view(m):
    return ([n.key for n in m.full], m.tail.key if m.tail else None,
            m.tail_len, m.hit_tokens, m.blocks())


def test_prefix_cache_matches_jax_step_for_step():
    """Lookups, shares, inserts and evictions on one template-heavy token
    stream give the same matches, the same allocator state and the same
    stats on both sides."""
    rng = np.random.default_rng(6)
    templates = [rng.integers(0, 50, 20).tolist() for _ in range(3)]
    pair = [(BlockAllocator(16), None), (JaxBlockAllocator(16), None)]
    pair = [(a, cls(a, 4)) for (a, _), cls in zip(pair, (PrefixCache,
                                                         JaxPrefixCache))]
    for step in range(60):
        toks = templates[rng.integers(3)][:int(rng.integers(5, 21))] \
            + rng.integers(0, 50, int(rng.integers(0, 6))).tolist()
        seq = step % 5
        views = []
        for alloc, pc in pair:
            alloc.free_seq(seq)
            alloc.start_seq(seq)
            m = pc.lookup(toks)
            pc.share(seq, m)
            n_new = -(-len(toks) // 4) - len(alloc.tables[seq])
            try:
                alloc.alloc(seq, n_new)
                pc.insert(toks, alloc.tables[seq], len(toks))
                fit = True
            except MemoryError:
                fit = False
            views.append((_match_view(m), fit, _alloc_state(alloc),
                          dataclasses.asdict(pc.stats), pc.tree.n_nodes))
        assert views[0] == views[1], step
    assert pair[0][1].stats.evicted_blocks > 0


@pytest.mark.parametrize("hist,k", [
    ([1, 2, 3, 4, 5, 9, 9, 1, 2, 3], 4), ([7, 7, 1, 2, 1, 2, 1, 2], 5),
    ([1, 2, 3, 8, 3, 5, 1, 2, 3], 1), ([1, 2, 3, 4, 5], 4), ([], 4)])
def test_ngram_drafter_matches_jax(hist, k):
    for n in (1, 2, 3):
        assert NGramDrafter(max_ngram=n).propose(0, hist, k) == \
            JaxNGramDrafter(max_ngram=n).propose(0, hist, k)
    rng = np.random.default_rng(len(hist))
    for _ in range(50):
        h = rng.integers(0, 4, int(rng.integers(0, 30))).tolist()
        assert NGramDrafter().propose(0, h, 4) == JaxNGramDrafter().propose(0, h, 4)


def test_paged_kv_cache_append_and_gather(rng):
    cfg = PagedKVConfig(n_blocks=8, block_size=4, n_kv_heads=2, head_dim=8)
    k_all = rng.standard_normal((11, 2, 8)).astype(np.float32)
    v_all = rng.standard_normal((11, 2, 8)).astype(np.float32)
    batched, loop = PagedKVCache(cfg, "cpu"), PagedKVCache(cfg, "cpu")
    batched.append(7, torch.from_numpy(k_all[:6]), torch.from_numpy(v_all[:6]))
    batched.append(7, torch.from_numpy(k_all[6:]), torch.from_numpy(v_all[6:]))
    for t in range(11):
        loop.append(7, torch.from_numpy(k_all[t:t + 1]),
                    torch.from_numpy(v_all[t:t + 1]))
    for cache in (batched, loop):
        kb, vb, ln = cache.gather(7)
        assert ln == 11
        np.testing.assert_array_equal(kb.numpy(), k_all)
        np.testing.assert_array_equal(vb.numpy(), v_all)
    batched.release(7)
    assert batched.alloc.check(expect_used=0) == []


def test_paged_kv_cache_needs_the_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = PagedKVConfig(n_blocks=2, block_size=4, n_kv_heads=1, head_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(cfg)
    assert PagedKVCache(cfg, "cpu").k.device.type == "cpu"


def test_memory_budget_and_block_bytes_match_jax(model):
    from repro.serving import kv_block_bytes as jax_kv_block_bytes
    cfg, jcfg, *_ = model
    full, jfull = get_config("smollm-135m"), jax_get_config("smollm-135m")
    assert kv_block_bytes(full, 8) == jax_kv_block_bytes(jfull, 8) == 368_640
    for budget in (0.5, 2e6, 3e6, 2e7):
        mine = PagedEngineConfig.from_memory_budget(full, budget, block_size=8)
        ref = JaxPagedEngineConfig.from_memory_budget(jfull, budget,
                                                      block_size=8)
        assert (mine.n_blocks, mine.usable_blocks, mine.max_blocks) == \
            (ref.n_blocks, ref.usable_blocks, ref.max_blocks)


# ------------------------------------------------------------ paged engine

def _mk(specs):
    """(port requests, JAX requests) from (rid, tokens, out, slo, arrival)."""
    mk = lambda cls: [cls(rid=rid, tokens=list(t), input_len=len(t), slo=slo,
                          arrival=arr, true_output_len=out)
                      for rid, t, out, slo, arr in specs]
    return mk(Request), mk(JaxRequest)


def _wl(cfg, n, seed=5):
    """The JAX package's test_paged_engine stream: 10-token prompts."""
    reqs = workload.gen_requests(workload.WorkloadConfig(
        n_requests=n, seed=seed, vocab=cfg.vocab_size))
    return [(r.rid, [t % cfg.vocab_size for t in r.tokens[:10]],
             min(r.true_output_len % 8 + 1, 8), r.slo, r.arrival) for r in reqs]


def _rand(cfg, n, in_len=20, out_max=8, seed=5):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, in_len).tolist(),
             int(rng.integers(1, out_max + 1)), 30.0, 0.0) for i in range(n)]


def _spec(cfg, n=6, seed=3, rep=True, out=(4, 12)):
    rng = np.random.default_rng(seed)
    out_specs = []
    for i in range(n):
        pat = rng.integers(1, cfg.vocab_size, 6 if rep else 20).tolist()
        toks = (pat * 4)[:20]
        out_specs.append((i, toks, int(rng.integers(*out)), 60.0, 0.0))
    return out_specs


def _templates(cfg, n=6, seed=7):
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(0, cfg.vocab_size, 24).tolist() for _ in range(2)]
    return [(i, tmpl[i % 2] + rng.integers(0, cfg.vocab_size, 8).tolist(),
             int(rng.integers(2, 8)), 10.0, float(i)) for i in range(n)]


def _stack(cfg):
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg.vocab_size, 16).tolist()
    return [(i, shared + (shared[:4] * 3)[:int(rng.integers(4, 12))],
             int(rng.integers(3, 10)),
             1000.0 if i == 0 else float(rng.uniform(0.001, 50)), 0.0)
            for i in range(8)]


def _multiturn(cfg, model):
    """A follow-up whose prompt embeds a finished answer: its match ends
    in the finished chain's partial tail block (copy-on-write)."""
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, cfg.vocab_size, 12).tolist()
    first, _ = _mk([(0, p1, 4, 10.0, 0.0)])
    ans = PagedEngine(cfg, model, PagedEngineConfig(
        max_batch=1, block_size=BS, n_blocks=64, max_seq_len=64,
        max_new_tokens=12)).run_continuous(first).outputs[0]
    p2 = p1 + ans + rng.integers(0, cfg.vocab_size, 21).tolist()
    return [(0, p1, 4, 10.0, 0.0), (1, p2, 4, 10.0, 1.0)]


def _lookahead(cfg):
    rng = np.random.default_rng(9)
    return [(0, rng.integers(0, cfg.vocab_size, 10).tolist(), 12, 10.0, 0.0),
            (1, rng.integers(0, cfg.vocab_size, 20).tolist(), 12, 10.0, 1.0),
            (2, rng.integers(0, cfg.vocab_size, 8).tolist(), 4, 10.0, 2.0)]


def _preempt(cfg):
    rng = np.random.default_rng(11)
    return [(0, [3] * 16, 6, 1000.0, 0.0),
            (1, rng.integers(1, cfg.vocab_size, 8).tolist(), 4, 0.001, 0.0)]


class _WrongDrafter:
    """Always-rejected drafts: every verify window rolls back."""
    name = "wrong"

    def propose(self, slot, history, k):
        return [VOCAB - 1] * k

    def release(self, slot):
        pass


# name -> (request specs, PagedEngineConfig overrides, drafter maker)
SCENARIOS = {
    "plain": (lambda c, m: _wl(c, 7), {}, None),
    "backpressure": (lambda c, m: _wl(c, 5), dict(n_blocks=8), None),
    "lookahead": (lambda c, m: _lookahead(c),
                  dict(max_batch=2, n_blocks=7, admit_lookahead=2), None),
    "chunked": (lambda c, m: _rand(c, 6), dict(chunk_tokens=8), None),
    "preempt": (lambda c, m: [(0, [3] * 8, 8, 1000.0, 0.0),
                              (1, [5] * 8, 4, 0.001, 0.0)],
                dict(max_batch=2, n_blocks=4, max_seq_len=32,
                     max_new_tokens=8, preempt=True), None),
    "spec_ngram": (lambda c, m: _spec(c), dict(spec_tokens=4), None),
    "spec_random": (lambda c, m: _spec(c, rep=False), dict(spec_tokens=3),
                    None),
    "spec_model": (lambda c, m: _spec(c, n=4), dict(spec_tokens=4), "model"),
    "spec_rollback": (lambda c, m: _spec(c, n=3, out=(6, 10)),
                      dict(max_batch=3, block_size=4, n_blocks=96,
                           spec_tokens=8), "wrong"),
    "spec_preempt": (lambda c, m: _preempt(c),
                     dict(max_batch=2, n_blocks=5, max_seq_len=32,
                          max_new_tokens=8, chunk_tokens=8, preempt=True,
                          spec_tokens=3), None),
    "spec_full_stack": (lambda c, m: _stack(c),
                        dict(max_batch=3, n_blocks=24, max_seq_len=48,
                             max_new_tokens=10, spec_tokens=3,
                             prefix_cache=True, chunk_tokens=8, preempt=True,
                             admit_lookahead=2), None),
    "prefix": (lambda c, m: _templates(c), dict(prefix_cache=True), None),
    "prefix_cow_chunked": (_multiturn, dict(max_batch=1, prefix_cache=True,
                                            chunk_tokens=8), None),
    "prefix_aligned": (_multiturn, dict(max_batch=1, prefix_cache=True,
                                        share_partial_tails=False), None),
    "prefix_evict": (lambda c, m: [(i, np.random.default_rng(5 + i).integers(
        0, c.vocab_size, 16).tolist(), 3, 10.0, float(i)) for i in range(6)],
        dict(max_batch=2, n_blocks=9, max_seq_len=32, max_new_tokens=8,
             prefix_cache=True), None),
}


def _serve_both(model, specs, pcfg_kw, drafter=None, **run_kw):
    cfg, jcfg, jparams, tmodel = model
    kw = dict(max_batch=4, block_size=BS, n_blocks=64, max_seq_len=64,
              max_new_tokens=12)
    kw.update(pcfg_kw)
    reqs, jreqs = _mk(specs)
    drafters = {"model": (ModelDrafter(cfg, tmodel),
                          JaxModelDrafter(jcfg, jparams)),
                "wrong": (_WrongDrafter(), _WrongDrafter()),
                None: (None, None)}[drafter]
    tr, jtr = Tracer(), JaxTracer()
    res = PagedEngine(cfg, tmodel, PagedEngineConfig(**kw), drafter=drafters[0],
                      tracer=tr).run_continuous(reqs, **run_kw)
    jres = JaxPagedEngine(jcfg, jparams, JaxPagedEngineConfig(**kw),
                          drafter=drafters[1], tracer=jtr).run_continuous(
        jreqs, **run_kw)
    return res, jres, tr, jtr


def _same_result(res, jres):
    assert res.outputs == jres.outputs
    for f in dataclasses.fields(jres):
        if f.name not in CLOCKED:
            assert getattr(res, f.name) == getattr(jres, f.name), f.name
    assert len(res.inter_token_s) == len(jres.inter_token_s)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_paged_engine_matches_jax(model, name):
    """Token-identical outputs, equal counters (all but the clocked ones)
    and the same trace event sequence as the JAX PagedEngine."""
    make, pcfg_kw, drafter = SCENARIOS[name]
    res, jres, tr, jtr = _serve_both(model, make(model[0], model[3]), pcfg_kw,
                                     drafter)
    _same_result(res, jres)
    assert [(e.name, e.ph, e.row) for e in tr.events] == \
        [(e.name, e.ph, e.row) for e in jtr.events]
    assert res.steps > 0 and res.outputs


def test_paged_engine_abort_and_resume_match_jax(model):
    """A request aborted mid-decode keeps its partial output, bystanders are
    unaffected, and a fresh engine resuming it from that partial output
    (with the prefix cache on) finishes it as an unfailed run does."""
    cfg = model[0]
    specs = _wl(cfg, 4)
    victim = max(specs, key=lambda s: s[2])[0]
    full, _, _, _ = _serve_both(model, specs, {})
    res, jres, _, _ = _serve_both(model, specs, dict(prefix_cache=True),
                                  abort_at={victim: 2, specs[0][0]: 0})
    _same_result(res, jres)
    assert res.aborted == 2 and res.errors[victim] == "aborted"
    partial = res.outputs[victim]
    assert partial == full.outputs[victim][:len(partial)]
    again, jagain, _, _ = _serve_both(
        model, [s for s in specs if s[0] == victim], dict(prefix_cache=True),
        resume={victim: partial})
    _same_result(again, jagain)
    assert again.outputs[victim] == full.outputs[victim]


# -------------------------------------------------------------- serve CLI

@pytest.fixture(scope="module")
def jax_pred():
    """The serve path's JAX predictor: seed 0, 8 epochs on 256 pairs."""
    pred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=VOCAB), seed=0)
    toks, lens = jax_workload.train_pairs(
        jax_workload.WorkloadConfig(vocab=VOCAB), 256, seed=1)
    pred.fit(toks, lens, epochs=8)
    return pred


FLAG_SETS = {
    "a": ["--paged"],
    "b": ["--prefix-cache", "--workload", "shared-prefix", "--chunk-tokens",
          "16"],
    "c": ["--speculate", "--spec-tokens", "4"],
}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_serve_paged_prints_the_jax_digest(capsys, monkeypatch, model,
                                           jax_pred, flags):
    """``serve.main`` with the paged flags, given the JAX run's weights and
    fitted predictor, prints the JAX serve's outputs digest and paged
    summary; the padded path on the same requests gives the same digest."""
    argv = FLAG_SETS[flags]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jax_serve.main()
    printed = capsys.readouterr().out
    cfg, _, _, tmodel = model
    monkeypatch.setattr(serve.api, "init_params", lambda *a, **k: tmodel)
    monkeypatch.setattr(serve, "fit_predictor", lambda c, d: predictor_from_numpy(
        jax.tree.map(np.array, jax_pred.params),
        profiler.PredictorConfig(vocab=VOCAB), device="cpu"))
    out = serve.main([*argv, "--device", "cpu"])
    mine = capsys.readouterr().out
    for pattern in (r"outputs_digest=(\w+)", r"^paged pool: (.*)$",
                    r"^paged: (.*)$", r"^prefix: (.*)$",
                    r"^speculate: (\d+ drafts/iter \(\w+\), acceptance=\S+)"):
        want = re.search(pattern, printed, re.M)
        got = re.search(pattern, mine, re.M)
        assert (got and got.group(1)) == (want and want.group(1)), pattern
    workload_name = argv[argv.index("--workload") + 1] \
        if "--workload" in argv else "alpaca"
    reqs = serve.make_requests(cfg, 12, 16, workload_name)
    padded = serve.serve(cfg, tmodel, reqs,
                         serve.fit_predictor(cfg.vocab_size, "cpu"))
    assert padded["digest"] == out["digest"]
