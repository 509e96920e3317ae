"""The port's continuous batcher: slot helpers against the JAX package's,
greedy streams under batching against single-stream decoding, the decode
loop on the device against the per-token host loop, drains over several
segments, stop tokens and slot reuse, and the port's greedy streams
against the JAX package's ContinuousBatcher on the same w8a8 megakernel
model. The models run on the CPU (kernels K3/K4 through their plain
versions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.serve import ServingModel as JServingModel
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.parallel import batching as JB
from rwkv_tpu.ops.parity import Weight
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.parallel import batching as TB

SMALL = ("7.0", 2, 128, 256, 32)  # version, L, C, V, S (H = 4)
PROMPTS = [[3, 77, 200, 5, 9], [9, 4], [100, 101, 102, 7, 7, 8, 1, 250, 42, 13, 6, 90, 17, 3, 2,
                                        64, 5, 5]]


def jax_tree_to_numpy(tree):
    def leaf(x):
        return np.asarray(x.w if isinstance(x, Weight) else x, np.float32)

    return {
        "emb": leaf(tree["emb"]),
        "ln0": tuple(leaf(x) for x in tree["ln0"]),
        "ln_out": tuple(leaf(x) for x in tree["ln_out"]),
        "head": leaf(tree["head"]),
        "blocks": [{k: leaf(v) for k, v in b.items()} for b in tree["blocks"]],
    }


@pytest.fixture(scope="module")
def models():
    jc, tc = j_synth_config(*SMALL), synth_config(*SMALL)
    jp = j_synth_params(jc, seed=11, lora_dim=32)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    srv = ServingModel((tc, tp), precision="w8a8", megakernel=True, device="cpu")
    return jc, jp, srv


def _run(srv, prompts, on_device, max_batch=2, sync_every=3, cap=None, **kw):
    b = TB.ContinuousBatcher(srv, max_batch=max_batch, sync_every=sync_every)
    if cap is not None:
        b.DRAIN_ROUNDS_CAP = cap
    rids = [b.submit(p, **kw) for p in prompts]
    res = b.run(on_device=on_device)
    assert b.n_active == 0 and not b.queue
    return [res[r].generated for r in rids]


def test_slot_helpers_equal_jax():
    rng = np.random.default_rng(0)
    pool = {"att_xx": rng.standard_normal((4, 2, 8)).astype(np.float32),
            "heads": rng.standard_normal((4, 2, 2, 3, 3)).astype(np.float32)}
    one = {k: rng.standard_normal((1,) + v.shape[1:]).astype(np.float32) for k, v in pool.items()}
    rows = {k: rng.standard_normal((2,) + v.shape[1:]).astype(np.float32) for k, v in pool.items()}
    idx = np.array([3, 1])

    def t(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    def j(tree):
        return {k: jnp.asarray(v) for k, v in tree.items()}

    checks = [
        (TB.write_slot(t(pool), 2, t(one)), JB.write_slot(j(pool), 2, j(one))),
        (TB.take_rows(t(pool), idx), JB.take_rows(j(pool), idx)),
        (TB.scatter_rows(t(pool), t(rows), idx), JB.scatter_rows(j(pool), j(rows), idx)),
    ]
    for got, ref in checks:
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_batched_greedy_equals_single_stream_greedy(models):
    """Under batching (B=2, so the K4 route, and queueing with slot reuse)
    each greedy stream equals the sequence decoded alone at B=1 (K3)."""
    _, _, srv = models
    n_new = 6
    singles = []
    for p in PROMPTS:
        logits, state = srv.prefill(p)
        toks = []
        for _ in range(n_new):
            toks.append(int(logits.argmax()))
            lg, state = srv.decode([toks[-1]], state)
            logits = lg[0]
        singles.append(toks)
    assert _run(srv, PROMPTS, True, max_new_tokens=n_new, temperature=0.0) == singles


def test_device_loop_matches_host_loop_with_penalties(models):
    _, _, srv = models
    kw = dict(max_new_tokens=7, temperature=0.0, presence_penalty=0.4, frequency_penalty=0.25)
    assert _run(srv, PROMPTS, True, **kw) == _run(srv, PROMPTS, False, **kw)


def test_device_drain_multi_segment(models):
    """A drain longer than DRAIN_ROUNDS_CAP rounds spans several segments
    (cap 2, sync_every 2, 9 tokens: three) and still matches the host."""
    _, _, srv = models
    kw = dict(max_new_tokens=9, temperature=0.0)
    got = _run(srv, PROMPTS[:2], True, sync_every=2, cap=2, **kw)
    assert got == _run(srv, PROMPTS[:2], False, sync_every=2, **kw)
    assert all(len(g) == 9 for g in got)


@pytest.mark.parametrize("on_device", [True, False])
def test_stop_tokens_and_slot_reuse(models, on_device):
    _, _, srv = models
    b = TB.ContinuousBatcher(srv, max_batch=2)
    rid_long = b.submit([1, 2], max_new_tokens=3, temperature=0.0)
    rid_short = b.submit([3, 4], max_new_tokens=10, temperature=0.0,
                         stop_tokens=tuple(range(256)))
    rid_third = b.submit([5, 6], max_new_tokens=2, temperature=0.0)
    res = b.run(on_device=on_device)
    assert len(res[rid_long].generated) == 3
    assert len(res[rid_short].generated) == 1
    assert len(res[rid_third].generated) == 2
    assert b.n_active == 0


def test_sampled_requests_finish_in_range(models):
    _, _, srv = models
    b = TB.ContinuousBatcher(srv, max_batch=2, sync_every=4, seed=3)
    rids = [b.submit(p, max_new_tokens=5, temperature=1.0, top_p=0.8) for p in PROMPTS]
    res = b.run(on_device=True)
    for r in rids:
        assert len(res[r].generated) == 5
        assert all(0 <= t < 256 for t in res[r].generated)


def test_greedy_streams_match_jax_batcher(models):
    """The JAX package's batcher on the same w8a8 megakernel model with its
    mega_min_batch at 2 (its B=2 decode then runs the lane-packed batched
    kernel in interpret mode), drained on its device loop to the end."""
    jc, jp, srv = models
    jsrv = JServingModel((jc, jp), precision="w8a8", megakernel=True)
    jsrv.mega_min_batch = 2
    jb = JB.ContinuousBatcher(jsrv, max_batch=2, sync_every=3)
    kw = dict(max_new_tokens=6, temperature=0.0)
    rids = [jb.submit(p, **kw) for p in PROMPTS]
    res = jb.run(on_device=True)
    assert _run(srv, PROMPTS, True, **kw) == [res[r].generated for r in rids]


def test_run_submit_run_equals_fresh_host_run(models):
    """A second run() on the same batcher starts from the logits its
    admissions wrote, never from a stale copy left by the first run (the
    JAX batcher re-seeds its device logits from such a copy)."""
    _, _, srv = models
    kw = dict(max_new_tokens=5, temperature=0.0, presence_penalty=0.3)
    b = TB.ContinuousBatcher(srv, max_batch=2, sync_every=2)
    b.submit(PROMPTS[0], **kw)
    b.run(on_device=True)
    rids = [b.submit(p, **kw) for p in PROMPTS[1:]]
    res = b.run(on_device=True)
    assert [res[r].generated for r in rids] == _run(srv, PROMPTS[1:], False, sync_every=2, **kw)
