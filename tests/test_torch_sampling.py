"""The port's in-window sampler and its decode window, on the CPU.

``decoder.sample_tokens`` keeps one counter-based key per slot: a slot's
draws depend on (seed, request id, its own step count) alone.  Held
here: greedy is the first maximal index, as the reference's argmax; the
keys advance every call whatever the temperature; a draw does not depend
on the batch it sits in; the continuous engine gives a request the same
sampled tokens whatever its ``sync_every``, slot count or neighbours;
Gumbel-max frequencies at a small vocab follow ``softmax(logits / T)``;
and the captured-window glue (``serve.graphs``, which on the CPU runs
the step as it is) gives the eager loop's tokens, keys and pool bytes.
Sampled streams cannot match JAX's threefry keys (ROADMAP numerics
rules), so there is no cross-framework check of sampled tokens.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.spec import QuantPolicy
from repro_torch.models import Model, load_reduced
from repro_torch.models.decoder import request_keys, sample_tokens
from repro_torch.serve import ContinuousBatchingEngine, GenerationConfig
from repro_torch.serve import ServeEngine
from repro_torch.serve.graphs import PagedDecodeGraph, StaticDecodeGraph
from repro_torch.serve.paging import TRASH_PAGE
from repro_torch.serve.scheduler import request_seed

torch.set_num_threads(1)

POLICY = "weights=e4m3@32:ocp,kv_key=int8@32:ocp,kv_value=e2m1@32:ocp"
LENS = [4, 9, 14, 4, 9, 14, 9, 4]
NEW, PAGE = 6, 8


def _keys(seed, rids):
    return request_keys(torch.tensor([request_seed(seed, r) for r in rids]))


def test_greedy_is_first_max_and_keys_advance():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                           [-1.0, -2.0, 7.0, 7.0]])
    keys = _keys(0, [0, 1, 2])
    new, tok = sample_tokens(logits, keys, 0.0)
    assert tok.tolist() == [1, 0, 2] and tok.dtype == torch.int32
    assert torch.equal(new[:, 0], keys[:, 0])
    assert torch.equal(new[:, 1], keys[:, 1] + 1)
    new_hot, _ = sample_tokens(logits, keys, 0.8)
    assert torch.equal(new_hot, new)         # the same schedule at any T


def test_draws_do_not_depend_on_the_batch():
    """A row's draw is a function of its own key and logits: drawn in a
    batch of 6, alone, or in another order, it is the same."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(6, 50)).astype(np.float32))
    keys = _keys(7, range(6))
    keys[:, 1] = torch.tensor([0, 3, 5, 9, 2, 1])
    _, batch = sample_tokens(logits, keys, 0.8)
    for i in range(6):
        _, one = sample_tokens(logits[i:i + 1], keys[i:i + 1], 0.8)
        assert one.item() == batch[i].item()
    perm = torch.tensor([5, 3, 1, 0, 2, 4])
    _, shuffled = sample_tokens(logits[perm], keys[perm], 0.8)
    assert torch.equal(shuffled, batch[perm])
    _, other = sample_tokens(logits, _keys(8, range(6)), 0.8)
    assert not torch.equal(other, batch)     # another seed, another draw


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_frequencies_follow_softmax(temperature):
    """20000 draws over an 8-entry vocab (one stream, its first 20000
    steps): each entry's frequency lies within 5 standard deviations of
    softmax(logits / T), sqrt(p (1 - p) / n) — a bound a correct sampler
    misses with probability below 1e-5 per entry."""
    n = 20000
    logits = torch.tensor([1.0, 0.0, -0.5, 2.0, 0.3, -2.0, 1.5, 0.9])
    keys = _keys(11, [0]).repeat(n, 1)
    keys[:, 1] = torch.arange(n)
    _, tok = sample_tokens(logits.repeat(n, 1), keys, temperature)
    freq = torch.bincount(tok.long(), minlength=8).double() / n
    p = torch.softmax(logits.double() / temperature, dim=0)
    tol = 5 * torch.sqrt(p * (1 - p) / n)
    assert ((freq - p).abs() <= tol).all(), (freq, p)


def _model():
    cfg = load_reduced("chatglm3_6b", mx=QuantPolicy.parse(POLICY),
                       attn_impl="flash")
    model = Model(cfg, device="cpu")
    return model, model.init(seed=0, quantize=True)


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _serve(model, params, prompts, **kw):
    eng = ContinuousBatchingEngine(
        model, params, page_size=PAGE, max_len=max(LENS) + NEW + 1,
        gen=GenerationConfig(temperature=0.8, seed=5), **kw)
    rids = [eng.add_request(p, NEW) for p in prompts]
    out = eng.run()
    return [out[r].tolist() for r in rids]


def test_sync_every_and_batch_do_not_change_sampled_tokens():
    """At T 0.8: sync_every 1 = 8 = 3, and 4 slots = 2 slots = 8 slots
    (other admission orders, other neighbours, other slots)."""
    model, params = _model()
    prompts = _prompts(model.cfg.vocab)
    want = _serve(model, params, prompts, max_slots=4, sync_every=1)
    assert _serve(model, params, prompts, max_slots=4, sync_every=8) == want
    assert _serve(model, params, prompts, max_slots=4, sync_every=3) == want
    assert _serve(model, params, prompts, max_slots=2, sync_every=8) == want
    assert _serve(model, params, prompts, max_slots=8, sync_every=4) == want
    greedy = ContinuousBatchingEngine(model, params, max_slots=4,
                                      page_size=PAGE,
                                      max_len=max(LENS) + NEW + 1)
    rids = [greedy.add_request(p, NEW) for p in prompts]
    out = greedy.run()
    assert [out[r].tolist() for r in rids] != want


def test_static_engine_rows_sample_their_request_streams():
    """Static row b samples from the stream of request id b: one prompt
    served statically at row 0 gives the continuous engine's tokens for
    rid 0 (one request, one bucket: the same prefill)."""
    model, params = _model()
    prompt = _prompts(model.cfg.vocab)[2]
    cont = _serve(model, params, [prompt], max_slots=2, sync_every=4)
    static = ServeEngine(model, params, max_len=len(prompt) + NEW + 2)
    got = static.generate({"tokens": prompt[None]}, GenerationConfig(
        max_new_tokens=NEW, temperature=0.8, seed=5))
    assert got[0].tolist() == cont[0]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_window_glue_matches_eager_loop(temperature):
    """``PagedDecodeGraph`` (what the card replays; on the CPU the step
    runs as it is) against ``paged_decode_multi_step`` from the same
    state: tokens, lengths, budgets, keys, flags and every pool byte
    except the trash page, which the capture's warm-up writes."""
    model, params = _model()
    cfg = model.cfg
    rng = np.random.default_rng(3)
    slots, max_pages, n = 4, 4, 5
    pool = model.init_paged_cache(1 + slots * max_pages, PAGE)
    for leaf in pool.values():
        leaf.copy_(torch.from_numpy(rng.integers(
            0, 120, size=tuple(leaf.shape)).astype(np.uint8)))
    tables = torch.arange(1, 1 + slots * max_pages,
                          dtype=torch.int32).reshape(slots, max_pages)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=slots)
                           .astype(np.int32))
    lengths = torch.tensor([3, 9, 0, 17], dtype=torch.int32)
    remaining = torch.tensor([5, 2, 0, 4], dtype=torch.int32)
    keys = _keys(2, [4, 1, 0, 7])
    eager_pool = {k: v.clone() for k, v in pool.items()}
    want = model.paged_decode_multi_step(
        params, tok, eager_pool, tables, lengths, remaining, keys,
        n_steps=n, temperature=temperature, trash_page=TRASH_PAGE,
        health=True)
    w = PagedDecodeGraph(model, params, pool, slots=slots,
                         max_pages=max_pages, max_window=8,
                         temperature=temperature, health=True,
                         trash_page=TRASH_PAGE)
    assert w.step.graph is None and w.step.launches == {}
    w.state.copy_(torch.stack([tok, lengths, remaining]))
    w.block_tables.copy_(tables)
    w.keys.copy_(keys)
    w.run(n)
    assert torch.equal(w.tokens[:n], want[0])
    assert torch.equal(w.state[1], want[2]) and torch.equal(w.state[2],
                                                            want[3])
    assert torch.equal(w.keys, want[4]) and torch.equal(w.bad, want[5])
    for k in pool:
        assert torch.equal(pool[k][:, 1:], eager_pool[k][:, 1:]), k


def test_static_glue_matches_eager_loop():
    """``StaticDecodeGraph`` (the position kept on the device) against
    ``decode_step`` at host positions from the same prefill: tokens and
    every cache byte."""
    model, params = _model()
    cfg = model.cfg
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(3, 4)).astype(np.int32))
    g = StaticDecodeGraph(model, params, batch=3, max_len=12,
                          temperature=0.8)
    logits, cache, pos = model.prefill(params, prompts, max_len=12,
                                       cache=g.cache)
    keys, tok = sample_tokens(logits[:, -1, :cfg.vocab], _keys(1, range(3)),
                              0.8)
    eager = {k: v.clone() for k, v in cache.items()}
    t, k, want = tok, keys, []
    for i in range(6):
        lg, _ = model.decode_step(params, t, eager, pos + i)
        k, t = sample_tokens(lg[:, -1, :cfg.vocab], k, 0.8)
        want.append(t)
    got = g.run(tok, keys, pos, 6)
    assert torch.equal(got, torch.stack(want))
    assert int(g.pos) == pos + 6 and torch.equal(g.keys, k)
    for name in cache:
        assert torch.equal(g.cache[name], eager[name]), name

