"""Port parity: the inner step. LR schedules against the JAX package's
optax schedules at every step; the optimizer against optax's
``chain(clip_by_global_norm, adamw)``; every loss; the causal label
layouts; and an 8-step training trajectory of a tiny f32 Llama started
from the JAX package's weights."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from _torch_parity import tiny_pair
from hypha_tpu import messages as jmsg
from hypha_tpu.executor import train as J
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor import train as T


def _sched(mod, kind, warmup, total, decay_start=0.9):
    return mod.LRScheduler(mod.LRSchedulerKind(kind), warmup, total, decay_start)


@pytest.mark.parametrize("kind,warmup,total", [
    ("constant", 0, 0),
    ("cosine-with-warmup", 5, 30),
    ("cosine-with-warmup", 0, 12),
    ("linear-with-warmup", 4, 20),
    ("wsd", 3, 25),
    ("wsd", 0, 10),
])
def test_lr_schedules_match_optax(kind, warmup, total):
    ref = J.make_lr_schedule(_sched(jmsg, kind, warmup, total), 3e-4)
    got = T.make_lr_schedule(_sched(tmsg, kind, warmup, total), 3e-4)
    # optax evaluates in f32, the port in Python floats: 1e-6 relative, or
    # 1e-7 of the base lr absolute (f32 cos near the end of a cosine decay).
    for n in range(total + 6):
        np.testing.assert_allclose(got(n), float(ref(n)), rtol=1e-6, atol=3e-11, err_msg=str(n))


def _leaves(rng):
    return {"a": rng.standard_normal((8, 5)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}


def test_optimizer_matches_optax_including_clipped_steps():
    """8 updates of AdamW (weight decay 0.1, warmup-cosine schedule) with
    global-norm clipping at 1.0: steps 0, 3 and 6 carry gradients whose
    norm is far above the threshold, the others far below. Gradients are
    drawn with |g| >= 1e-3, away from zero, where eps would make Adam's
    g / (|g| + eps) sensitive to rounding. Adam's first steps move each
    parameter by about lr, so the parameters are compared after scaling
    their difference by 1/lr: within 1e-4 (a one-ulp rounding difference of
    a parameter near 4 per step, at lr 0.1)."""
    rng = np.random.default_rng(0)
    params = _leaves(rng)
    adam_j = jmsg.Adam(lr=0.1, weight_decay=0.1)
    sched_j = _sched(jmsg, "cosine-with-warmup", 2, 10)
    tx = J.build_optimizer(adam_j, sched_j, max_grad_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = T.build_optimizer(tp, tmsg.Adam(lr=0.1, weight_decay=0.1),
                            _sched(tmsg, "cosine-with-warmup", 2, 10), max_grad_norm=1.0)
    for step in range(8):
        g = _leaves(rng)
        g = {k: np.where(np.abs(v) < 1e-3, 1e-3, v) * (30.0 if step % 3 == 0 else 0.05)
             for k, v in g.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k, t in zip(("a", "b"), tp):
            diff = np.abs(t.numpy() - np.asarray(jp[k])).max() / 0.1
            assert diff <= 1e-4, (step, k, diff)
    assert opt.count == 8


@pytest.mark.parametrize("max_grad_norm", [None, 1e3])
def test_bf16_first_moment_matches_optax(max_grad_norm):
    """``mu_dtype=bf16`` against ``optax.adamw(mu_dtype=bf16)`` over 6 steps
    of the same gradients (spanning four decades): the stored first moment
    bit-equal every step (optax rounds ``b1 · mu`` in bf16, adds
    ``(1 - b1) · g`` in f32 and stores the rounded sum), the second moment
    f32, the parameters within 1e-4 of lr (the update comes from the
    unrounded f32 moment in both; bias corrections round differently)."""
    rng = np.random.default_rng(7)
    params = _leaves(rng)
    adam = dict(lr=0.1, weight_decay=0.1)
    tx = J.build_optimizer(jmsg.Adam(**adam), None, max_grad_norm=max_grad_norm,
                           mu_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = T.build_optimizer(tp, tmsg.Adam(**adam), max_grad_norm=max_grad_norm,
                            mu_dtype=torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 for m in opt.mu)
    assert all(v.dtype == torch.float32 for v in opt.nu)
    for step in range(6):
        g = {k: v * 10.0 ** (step % 4 - 2) for k, v in _leaves(rng).items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])])
        adam_state = next(x for x in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))
        for i, k in enumerate(("a", "b")):
            want = np.asarray(adam_state.mu[k].astype(jnp.float32))
            np.testing.assert_array_equal(opt.mu[i].float().numpy(), want, err_msg=f"{step} {k}")
            assert np.abs(tp[i].numpy() - np.asarray(jp[k])).max() / 0.1 <= 1e-4, (step, k)


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_causal_ce_matches_jax(chunk):
    """``chunked_causal_ce`` at an odd S (a ragged tail padded with ignored
    positions) with -100 labels, value and gradients (hidden and head)
    against the JAX package's: within 1e-6 (and so within
    ``chip_smoke.CHUNKED_CE_TOL``, 1e-5 of the loss, the card's probe's
    bound) and 1e-6 relative to the largest gradient (f32 sums in another
    order); equal to ``compute_loss`` CE on the full logits within 1e-6."""
    rng = np.random.default_rng(8)
    B, S, D, V = 2, 23, 16, 40
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, 3] = labels[1, 0] = labels[1, S - 1] = -100

    def jloss(h, w):
        return J.chunked_causal_ce(h, w, jnp.asarray(labels), chunk=chunk)

    jval, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(hidden),
                                                                jnp.asarray(head))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(head).requires_grad_(True)
    val = T.chunked_causal_ce(th, tw, torch.from_numpy(labels).long(), chunk=chunk)
    gh, gw = torch.autograd.grad(val, [th, tw])
    np.testing.assert_allclose(float(val.detach()), float(jval), atol=1e-6, rtol=0)
    assert abs(float(val.detach()) - float(jval)) <= chip_smoke.CHUNKED_CE_TOL * abs(float(jval))
    for got, want in ((gh, jgh), (gw, jgw)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    full = T.compute_loss(tmsg.Loss.CROSS_ENTROPY, th @ tw.T, torch.from_numpy(labels))
    np.testing.assert_allclose(float(val.detach()), float(full.detach()), atol=1e-6, rtol=0)
    with torch.no_grad():  # no autograd: the chunks run without recompute
        assert abs(float(T.chunked_causal_ce(th, tw, torch.from_numpy(labels), chunk=chunk))
                   - float(val.detach())) <= 1e-6


@pytest.mark.parametrize("kind", ["cross-entropy", "nll", "mse", "mae", "bce-with-logits"])
def test_compute_loss_matches(kind):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    if kind in ("cross-entropy", "nll"):
        labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
        labels[0, 1] = labels[1, 4] = -100  # ignored positions
    elif kind == "bce-with-logits":
        labels = rng.integers(0, 2, logits.shape).astype(np.float32)
    else:
        labels = rng.standard_normal(logits.shape).astype(np.float32)
    ref = float(J.compute_loss(jmsg.Loss(kind), jnp.asarray(logits), jnp.asarray(labels)))
    got = float(T.compute_loss(tmsg.Loss(kind), torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_all_ignored_labels_give_zero_loss():
    logits = torch.zeros((1, 3, 4))
    labels = torch.full((1, 3), -100)
    assert float(T.compute_loss(tmsg.Loss.CROSS_ENTROPY, logits, labels)) == 0.0


_TABLE = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)


@pytest.mark.parametrize("layout,labels_aligned,causal", [
    ({"input_ids"}, False, True),  # next token over the inputs
    ({"input_ids", "labels"}, False, True),  # next token over explicit labels
    ({"input_ids", "decoder_input_ids"}, False, True),  # next token within the decoder
    ({"input_ids", "decoder_input_ids", "labels"}, False, True),  # aligned: no shift
    ({"input_ids", "labels"}, True, True),  # labels_aligned seq2seq contract
    ({"input_ids", "labels"}, False, False),  # not causal: logits vs labels
])
def test_label_layouts_match(layout, labels_aligned, causal):
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, 16, (2, 6)).astype(np.int32) for k in sorted(layout)}

    def apply_fn(params, inputs):
        return params[inputs]

    ref_fn = J.make_loss_fn(apply_fn, jmsg.Loss.CROSS_ENTROPY, causal_lm=causal,
                            labels_aligned=labels_aligned)
    ref_total, (ref_loss, _) = ref_fn(jnp.asarray(_TABLE), {k: jnp.asarray(v) for k, v in batch.items()}, 0)
    table = torch.from_numpy(_TABLE)
    got_fn = T.make_loss_fn(lambda ids: table[ids.long()], tmsg.Loss.CROSS_ENTROPY,
                            causal_lm=causal, labels_aligned=labels_aligned)
    total, loss, aux = got_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-6)
    assert float(aux) == 0.0


def test_eight_step_trajectory_matches_jax():
    """A tiny f32 Llama (2 layers, GQA 4/2) from the JAX package's weights,
    8 steps of AdamW with warmup-cosine LR, weight decay and clipping on
    the same batches: per-step loss within 1e-4 (f32 forward and backward
    in another summation order, compounding over 8 updates), the global
    gradient norm within 1e-4 relative. The final parameters, scaled by
    1/lr: 99.99% within 1e-3 (measured 8e-5), and every one within 0.05 —
    an embedding row whose token appears once gets a gradient near Adam's
    eps, where the normalized step g / (|g| + eps) amplifies the two
    frameworks' rounding (measured 0.017 for one element)."""
    jm, variables, tm = tiny_pair("llama", seed=5)
    adam = dict(lr=3e-3, weight_decay=0.01)
    tx = J.build_optimizer(jmsg.Adam(**adam), _sched(jmsg, "cosine-with-warmup", 2, 8))
    jstep = J.make_train_step(jm.apply, jmsg.Loss.CROSS_ENTROPY)
    state = J.TrainState.create(variables, tx)
    opt = T.build_optimizer(list(tm.parameters()), tmsg.Adam(**adam),
                            _sched(tmsg, "cosine-with-warmup", 2, 8))
    tstep = T.make_train_step(tm, opt, tmsg.Loss.CROSS_ENTROPY)
    rng = np.random.default_rng(6)
    start = rng.integers(0, 256, (8, 2, 1))
    for i in range(8):
        ids = ((start[i] + np.arange(16)) % 256).astype(np.int32)  # counting sequences
        state, metrics = jstep(state, {"input_ids": jnp.asarray(ids)})
        loss, total, aux, norm = tstep({"input_ids": torch.from_numpy(ids)})
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), atol=1e-4, err_msg=str(i))
        np.testing.assert_allclose(float(norm), float(metrics["grad_norm"]), rtol=1e-4)
        assert float(total) == float(loss) and float(aux) == 0.0
    from hypha_tpu.executor.serialization import flatten_tree
    from hypha_tpu_torch.models.convert import llama_params_to_flat

    ref = flatten_tree(jax.device_get(state.params))
    diffs = np.concatenate([
        (np.abs(got - ref[name]) / adam["lr"]).ravel()
        for name, got in llama_params_to_flat(tm).items()
    ])
    assert np.quantile(diffs, 0.9999) <= 1e-3
    assert diffs.max() <= 0.05
