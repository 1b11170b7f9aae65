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
    with pytest.raises(NotImplementedError, match="mu_dtype"):
        T.build_optimizer(tp, tmsg.Adam(), mu_dtype=torch.bfloat16)


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
