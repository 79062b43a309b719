"""The port's losses, regularizers, ramp and pooling heads against the JAX
package's, values and gradients (autograd against ``jax.grad``) on the
same seeded numpy inputs. Tolerance rtol 1e-5, atol 1e-6: both sides run
float32 and differ only in the order of their sums. The sparse head's
chunked masked max is also held bit-equal to the plain torch expression,
ties included.

At an exact zero the two frameworks give ``|x|`` different gradients (JAX
+1, torch 0); reps reach the regularizers through ``relu``, whose gradient
there is 0 in both, so the direct tests draw reps without exact zeros and
``test_regularizer_through_sparse_head`` holds the chain, zeros and all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.models import losses as ref
from scaling_retriever_tpu.ops import pooling as ref_pool
from scaling_retriever_tpu_torch.models import losses
from scaling_retriever_tpu_torch.ops import pooling

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BZ, NNEG, D = 4, 3, 24


def _inputs(seed=0, unit=False):
    """Seeded reps and teacher data; ``unit`` L2-normalizes the reps, as
    the dense head (the one with a temperature) makes them."""
    rng = np.random.default_rng(seed)
    q = np.abs(rng.standard_normal((BZ, D))).astype(np.float32) + 0.01
    c = np.abs(rng.standard_normal((BZ * (1 + NNEG), D))).astype(
        np.float32) + 0.01
    if unit:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
    teacher = rng.standard_normal((BZ, 1 + NNEG)).astype(np.float32)
    idxes = np.asarray([[i] + list(range(BZ + i * NNEG, BZ + (i + 1) * NNEG))
                        for i in range(BZ)], np.int32)
    return {"q": q, "c": c, "labels": np.arange(BZ, dtype=np.int32),
            "teacher": teacher, "idxes": idxes,
            "tpos": teacher[:, 0].copy(), "tneg": teacher[:, 1].copy()}


def _loss_pair(name, T):
    """(jax fn(q, c, x), torch fn(q, c, x)) of one scalar loss."""
    if name == "nce":
        return (lambda q, c, x: ref.nce_loss(q, c, x["labels"], T),
                lambda q, c, x: losses.nce_loss(q, c, x["labels"], T))
    if name == "margin_mse":
        def j(q, c, x):
            return ref.margin_mse_loss(q, c[:BZ], c[BZ:2 * BZ], x["tpos"],
                                       x["tneg"], T)

        def t(q, c, x):
            return losses.margin_mse_loss(q, c[:BZ], c[BZ:2 * BZ], x["tpos"],
                                          x["tneg"], T)
        return j, t
    if name == "kldiv":
        return (lambda q, c, x: ref.kldiv_loss(q, c, x["teacher"], T),
                lambda q, c, x: losses.kldiv_loss(q, c, x["teacher"], T))
    if name.startswith("nce_kldiv"):
        part = {"nce_kldiv": 0, "nce_kldiv.nce": 1, "nce_kldiv.kl": 2}[name]
        return (lambda q, c, x: ref.nce_kldiv_loss(
                    q, c, x["labels"], x["teacher"], x["idxes"], T)[part],
                lambda q, c, x: losses.nce_kldiv_loss(
                    q, c, x["labels"], x["teacher"], x["idxes"], T)[part])
    fn = {"l1": (ref.l1, losses.l1), "flops": (ref.flops, losses.flops),
          "l1_diff": (ref.l1_diff, losses.l1_diff)}[name]
    if name == "l1_diff":
        return (lambda q, c, x: fn[0](q, c[:BZ]),
                lambda q, c, x: fn[1](q, c[:BZ]))
    return (lambda q, c, x: fn[0](q) + fn[0](c),
            lambda q, c, x: fn[1](q) + fn[1](c))


@pytest.mark.parametrize("name", ["nce", "margin_mse", "kldiv", "nce_kldiv",
                                  "nce_kldiv.nce", "nce_kldiv.kl", "l1",
                                  "flops", "l1_diff"])
@pytest.mark.parametrize("T", [1.0, 0.05])
def test_loss_and_gradient_match_reference(name, T):
    x = _inputs(unit=T != 1.0)
    jfn, tfn = _loss_pair(name, T)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    want, (wq, wc) = jax.value_and_grad(
        lambda q, c: jfn(q, c, jx), argnums=(0, 1))(jx["q"], jx["c"])
    tq = torch.from_numpy(x["q"]).requires_grad_()
    tc = torch.from_numpy(x["c"]).requires_grad_()
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    got = tfn(tq, tc, tx)
    gq, gc = torch.autograd.grad(got, (tq, tc))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=RTOL,
                               atol=ATOL)


def test_statistics_and_init_regularizer():
    x = _inputs()["c"]
    for reg in ("L1", "L0", "FLOPS"):
        np.testing.assert_allclose(
            float(losses.init_regularizer(reg)(torch.from_numpy(x))),
            float(ref.init_regularizer(reg)(jnp.asarray(x))), rtol=RTOL)
    np.testing.assert_allclose(
        float(losses.init_regularizer("sparsity_ratio", output_dim=D)(
            torch.from_numpy(x))),
        float(ref.init_regularizer("sparsity_ratio", output_dim=D)(
            jnp.asarray(x))), rtol=RTOL)
    with pytest.raises(NotImplementedError):
        losses.init_regularizer("L2")
    with pytest.raises(ValueError):
        losses.l1_diff(torch.zeros(2, 3), torch.zeros(3, 2))


def test_ramp_matches_scheduler_and_reference():
    lam, T = 0.008, 7
    sched = losses.RegWeightScheduler(lam, T)
    ref_sched = ref.RegWeightScheduler(lam, T)
    for step in range(1, 12):
        assert sched.step() == ref_sched.step()
        want = float(ref.reg_weight_at_step(lam, T, jnp.asarray(step)))
        assert losses.reg_weight_at_step(lam, T, step) == want
        np.testing.assert_allclose(want, sched.get_lambda(), rtol=1e-6)
    assert losses.reg_weight_at_step(lam, T, 0) == 0.0


def _pool_inputs(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 6, 40)) * 2).astype(np.float32)
    x[0, 1] = x[0, 4]                        # tied maxima over the sequence
    x = torch.from_numpy(x).to(dtype).float().numpy()   # representable
    mask = np.array([[1] * 6, [0, 0, 1, 1, 1, 1], [0] * 5 + [1]], np.int32)
    w = rng.standard_normal((3, 40)).astype(np.float32)
    return x, mask, w


@pytest.mark.parametrize("head", ["sparse", "dense"])
def test_pooling_gradient_matches_reference(head):
    x, mask, w = _pool_inputs(torch.float32)
    if head == "sparse":
        jf = lambda a: jnp.sum(ref_pool.sparse_pool(a, mask, 64) * w)  # noqa
        tf = lambda a: (pooling.sparse_pool(a, torch.from_numpy(mask), 64)  # noqa
                        * torch.from_numpy(w)).sum()
    else:
        w = w[:, :x.shape[2]]
        jf = lambda a: jnp.sum(ref_pool.dense_pool(a, mask) * w)  # noqa
        tf = lambda a: (pooling.dense_pool(a, torch.from_numpy(mask))  # noqa
                        * torch.from_numpy(w)).sum()
    want, wg = jax.value_and_grad(jf)(jnp.asarray(x))
    a = torch.from_numpy(x).requires_grad_()
    got = tf(a)
    (g,) = torch.autograd.grad(got, a)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("reg", ["flops", "l1"])
def test_regularizer_through_sparse_head(reg):
    """The sparse head's reps (many exact zeros) into a regularizer: the
    gradient to the logits matches JAX's."""
    x, mask, _ = _pool_inputs(torch.float32)
    x = x - 1.5                                   # most reps at zero
    jr, tr = getattr(ref, reg), getattr(losses, reg)
    want, wg = jax.value_and_grad(
        lambda a: jr(ref_pool.sparse_pool(a, mask, 64)))(jnp.asarray(x))
    a = torch.from_numpy(x).requires_grad_()
    reps = pooling.sparse_pool(a, torch.from_numpy(mask), 64)
    assert (reps == 0).float().mean() > 0.3
    (g,) = torch.autograd.grad(tr(reps), a)
    np.testing.assert_allclose(float(tr(reps.detach())), float(want),
                               rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_sparse_pool_is_the_plain_expression(dtype, monkeypatch):
    """Values and gradients bit-equal to autograd of the plain expression,
    over several vocabulary chunks, with tied maxima."""
    monkeypatch.setattr(pooling, "_V_CHUNK", 16)
    x, mask, w = _pool_inputs(dtype)
    m, wt = torch.from_numpy(mask), torch.from_numpy(w)

    def plain(a):
        s = a.float() * (64 ** -0.25)
        pen = (1.0 - m.float())[:, :, None] * -1e6
        return torch.log(torch.relu((s + pen).amax(dim=1)) + 1.0)

    a = torch.from_numpy(x).to(dtype).requires_grad_()
    got = pooling.sparse_pool(a, m, 64)
    (g_got,) = torch.autograd.grad((got * wt).sum(), a)
    want = plain(a)
    (g_want,) = torch.autograd.grad((want * wt).sum(), a)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)
    assert g_got.dtype == dtype
    # the tie splits its gradient evenly
    assert (g_got[0, 1] != 0).any() and torch.equal(g_got[0, 1], g_got[0, 4])
