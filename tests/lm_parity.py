"""What the LM families' parity files share (dense, MoE): the SMOKE presets
of both packages, the reference's parameters handed to the port through
``params_from_jax``, numpy inputs from a seed, and the comparisons at the
tolerances each test file states.

Tolerances (fp32; the two packages sum in different orders):
  * logits and hidden states: max |Δ| <= ``LOGIT_TOL`` × max |reference|;
  * layer outputs and caches: ``ACT_TOL`` absolute.
"""

import jax
import numpy as np
import pytest

from repro import configs as R_configs
from repro.models import lm as R_lm
from repro_torch import configs
from repro_torch.models.convert import params_from_jax
from torch_parity import to_np

LOGIT_TOL = 1e-4
ACT_TOL = 1e-5


def smoke(arch, **kw):
    """The port's SMOKE config of ``arch`` and the reference's, with
    ``kw`` replaced in both."""
    return (configs.get_smoke(arch).with_(**kw),
            R_configs.get_smoke(arch).with_(**kw))


def ref_tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        R_lm.init_params(jax.random.PRNGKey(seed), rcfg))


def model_fixture(archs, name="model", **kw):
    """A module fixture ``name`` over ``archs``: (arch, port cfg, reference
    cfg, reference numpy tree, port LM), with ``kw`` replaced in both
    configs."""
    @pytest.fixture(scope="module", params=archs, name=name)
    def model(request):
        cfg, rcfg = smoke(request.param, **kw)
        rp = ref_tree(rcfg)
        return request.param, cfg, rcfg, rp, params_from_jax(rp, cfg,
                                                             device="cpu")
    return model


def tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def rng_normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def scaled_close(got, want, tol=LOGIT_TOL):
    got, want = to_np(got), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def close(got, want, atol=ACT_TOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float64),
                               rtol=0, atol=atol)
