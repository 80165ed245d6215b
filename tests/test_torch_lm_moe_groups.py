"""The MoE's dispatch groups on their data rank: on gloo ranks of the CPU
(``tests/_lm_ranks.py`` ``moe_groups``), the MoE smoke config in float32
on a batch split over data, against the one-device port run in this
process from the same seeds, within ``TOL`` (1e-4, the bound of
``test_torch_lm_sharded.py``).

The reference shards its dispatch groups over the batch axes
(``shard(xt, "batch", ...)``): a data rank routes and runs its own
groups.  With ``repro_torch.models.moe.GROUP`` set to ``SMALL_GROUP``
(16) in the ranks and here, a rank's rows are whole groups at the smoke
sizes: the MoE then gathers nothing over the batch axes, and its logits,
loss, aux loss (the global batch's: the two means summed over the batch
axes), gradients and a train step equal one device's.  With the default
GROUP a group spans the ranks' rows (as in every decode step): the MoE
still gathers, and still equals one device.
"""
import numpy as np
import pytest
import torch

import _lm_ranks as lr
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.tree import leaves

TOL = 1e-4
MESHES = {"2x2": (4, 2), "2x1": (2, 1)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request):
    world, model = MESHES[request.param]
    return spawn(lr.moe_groups, world, model, device="cpu", backend="gloo")


_ONE: dict = {}


def one_device() -> dict:
    """The one-device port: forwards at both group sizes, and at
    SMALL_GROUP the value and grad of ``train_loss`` and a train step."""
    if not _ONE:
        cfg = lr.f32(lr.MOE)
        p = lr.params(cfg)
        for group in (lr.SMALL_GROUP, moe_mod.GROUP):
            with lr.moe_group(group), torch.no_grad():
                lg, aux = tf.forward(cfg, p, lr.tokens(cfg))
            _ONE[group] = (lg, float(aux))
        with lr.moe_group(lr.SMALL_GROUP):
            _ONE["grads"] = lr.moe_grads(cfg, p, lr.batch(cfg, 0))
            state, ms = lr.train(cfg, lr.tcfg(), 1)
        _ONE["train"], _ONE["state"] = ms, leaves(state)
    return _ONE


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("group", [lr.SMALL_GROUP, moe_mod.GROUP],
                         ids=["own-groups", "spanning-groups"])
def test_forward_equals_one_device(ranks, group):
    """A rank's rows of the logits and the global aux loss equal one
    device's at both group sizes."""
    want_lg, want_aux = one_device()[group]
    D = 2
    for rank, r in enumerate(ranks):
        lg, aux = r[group, "forward"]
        d = rank // (len(ranks) // D)
        _close(lg, want_lg.chunk(D)[d])
        np.testing.assert_allclose(aux, want_aux, rtol=TOL, atol=TOL)


def test_own_groups_gather_nothing_over_the_batch(ranks):
    """Whole groups a rank: no all-gather over the batch axes inside the
    MoE, forward or train; the aux loss's two means cross the batch axes
    in one all-reduce of 2 × E float32 a layer."""
    cfg = lr.f32(lr.MOE)
    for r in ranks:
        assert r[lr.SMALL_GROUP, "forward_record"]["batch_gathers"] == []
        assert r["grads_record"]["batch_gathers"] == []
        events = r[lr.SMALL_GROUP, "forward_record"]["events"]
        aux = [e for e in events if e[:2] == ("all_reduce",
                                             2 * cfg.num_experts * 4)]
        assert len(aux) == cfg.num_layers


def test_spanning_groups_still_gather(ranks):
    """A group that spans the ranks' rows (the default GROUP at the smoke
    sizes): the MoE gathers the global batch's tokens over the batch axes,
    once a layer."""
    cfg = lr.f32(lr.MOE)
    B, S = lr.tokens(cfg).shape
    for r in ranks:
        got = r[moe_mod.GROUP, "forward_record"]["batch_gathers"]
        assert got == [B * S * cfg.d_model * 4] * cfg.num_layers


def test_train_step_equals_one_device(ranks):
    """Whole groups a rank: ``train_loss``'s loss and aux loss, every
    gradient (summed over the batch axes and gathered whole) and one
    train step's metrics and state equal one device's."""
    want = one_device()
    wm, wg = want["grads"]
    for r in ranks:
        gm, gg = r["grads"]
        for k in ("loss", "aux_loss"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        for g, w in zip(gg, wg, strict=True):
            assert g.shape == w.shape
            _close(g, w)
        assert len(r["train"]) == len(want["train"])
        for g, w in zip(r["train"], want["train"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                           err_msg=k)
        for g, w in zip(r["state"], want["state"], strict=True):
            _close(g, w)
