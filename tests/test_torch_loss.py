"""The port's multibox loss against the JAX package's ``models/loss.py``,
in value and gradient (``torch.autograd`` against ``jax.grad``), float32
on the CPU: within 1e-6 relative to the reference's largest magnitude.

The batch has a sample with no positive, one with more negatives than
three times its positives (hard-negative mining cuts) and one with fewer
(every negative kept), and ties among the negatives' cross-entropies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tensorflow_tpu.models import loss as jax_loss
from ssd_tensorflow_tpu_torch.models import loss

K = 4
A = 40
RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rtol * scale, (np.abs(got - want).max(), scale)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    b = 3
    cls = np.full((b, A), K)
    cls[1, [3, 17, 30]] = rng.integers(0, K, 3)  # 3 positives, 37 negatives > 9
    cls[2, :30] = rng.integers(0, K, 30)  # 30 positives, 10 negatives < 90
    labels = np.zeros((b, A, K + 5), np.float32)
    labels[np.arange(b)[:, None], np.arange(A)[None], cls] = 1.0
    pos = cls < K
    labels[..., K + 1:] = np.where(pos[..., None], rng.normal(0, 1.5, (b, A, 4)), 0.0)
    logits = rng.normal(0, 2, (b, A, K + 1)).astype(np.float32)
    logits[1, 20:26] = logits[1, 19]  # tied negatives
    locs = rng.normal(0, 1.5, (b, A, 4)).astype(np.float32)
    return logits, locs, labels


def test_smooth_l1():
    x = np.array([-3.0, -1.0, -0.999, -0.5, 0.0, 0.25, 0.999, 1.0, 2.5], np.float32)
    got = loss.smooth_l1(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_loss.smooth_l1(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(loss.smooth_l1(xt).sum(), xt)
    _close(g, jax.grad(lambda v: jax_loss.smooth_l1(v).sum())(x))


@pytest.mark.parametrize("term", ["confidence", "localization"])
def test_multibox_loss_value_and_grad(batch, term):
    logits, locs, labels = batch
    want = jax_loss.multibox_loss(logits, locs, labels, K)[term]
    jgl, jgo = jax.grad(lambda lg, lc: jax_loss.multibox_loss(lg, lc, labels, K)[term],
                        argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(locs))
    tl = torch.from_numpy(logits).requires_grad_()
    to = torch.from_numpy(locs).requires_grad_()
    got = loss.multibox_loss(tl, to, torch.from_numpy(labels), K)[term]
    _close(got, want)
    gl, go = torch.autograd.grad(got, (tl, to), allow_unused=True)
    _close(gl if gl is not None else torch.zeros_like(tl), jgl)
    _close(go if go is not None else torch.zeros_like(to), jgo)


def test_mining_counts(batch):
    """The sample without positives contributes 0; the mined negatives of
    sample 1 are its 9 largest cross-entropies."""
    logits, locs, labels = batch
    one = loss.multibox_loss(torch.from_numpy(logits[:1]), torch.from_numpy(locs[:1]),
                             torch.from_numpy(labels[:1]), K)
    assert float(one["confidence"]) == 0.0 and float(one["localization"]) == 0.0
    ce = -(torch.from_numpy(labels[1, :, : K + 1])
           * torch.log_softmax(torch.from_numpy(logits[1]), -1)).sum(-1)
    pos = torch.from_numpy(labels[1, :, K] == 0)
    neg = torch.sort(ce[~pos], descending=True).values[:9].sum()
    want = (ce[pos].sum() + neg) / 3.0
    got = loss.multibox_loss(torch.from_numpy(logits[1:2]), torch.from_numpy(locs[1:2]),
                             torch.from_numpy(labels[1:2]), K)["confidence"]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_l2_regularizer_and_total(batch):
    rng = np.random.default_rng(1)
    jp = {"conv1": {"w": rng.normal(0, 1, (3, 3, 2, 4)).astype(np.float32),
                    "b": rng.normal(0, 1, (4,)).astype(np.float32)},
          "l2_norm_conv4_3": {"scale": rng.normal(0, 1, (4,)).astype(np.float32)},
          "classifier0": {"w": rng.normal(0, 1, (3, 3, 4, 6)).astype(np.float32),
                          "b": np.zeros(6, np.float32)}}
    tp = {n: {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in d.items()}
          for n, d in jp.items()}
    # a staged inference filter is no parameter: skipped
    tp["classifier0"]["wb"] = torch.ones((6, 12, 3, 3))
    got = loss.l2_regularizer(tp)
    _close(got, jax_loss.l2_regularizer(jp))
    jg = jax.grad(jax_loss.l2_regularizer)(jp)
    for n in jp:
        for k in jp[n]:
            (g,) = torch.autograd.grad(got, tp[n][k], retain_graph=True, allow_unused=True)
            _close(g if g is not None else torch.zeros_like(tp[n][k]), jg[n][k])
    logits, locs, labels = batch
    jt = jax_loss.total_loss(logits, locs, labels, jp, K, 5e-4)
    tt = loss.total_loss(torch.from_numpy(logits), torch.from_numpy(locs),
                         torch.from_numpy(labels), tp, K, 5e-4)
    assert sorted(tt) == sorted(jt)
    for k in jt:
        _close(tt[k], jt[k])
