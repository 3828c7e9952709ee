"""The MoE router's discrete half against the JAX package: GShard top-k
dispatch and combine masks bitwise from the same probs (with drops and
ties), and ``moe_apply`` with tokens dropped within rtol = atol = 1e-5
(fp32, other sum orders) on the same weights.
"""

import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("k,capacity,ties", [(2, 4, False), (3, 4, False),
                                             (2, 64, False), (3, 5, True)])
def test_dispatch_masks_bitwise_jax(k, capacity, ties):
    """GShard top-k dispatch and combine masks from the same router probs
    bitwise equal to JAX's: 4 groups of 32 tokens over 8 experts, with
    capacity 4 and 5 (tokens dropped) and 64 (none), and probs rounded to
    tenths (ties, broken to the lowest expert on both sides)."""
    import jax.numpy as jnp
    import numpy as np

    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    logits = np.random.default_rng(11).standard_normal((4, 32, 8))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if ties:
        probs = np.round(probs, 1)
    probs = probs.astype(np.float32)
    jd, jc = jmoe._top_k_dispatch(jnp.asarray(probs), k, capacity)
    td, tc = tmoe._top_k_dispatch(torch.as_tensor(probs), k, capacity)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    kept = td.numpy().sum(axis=(2, 3))   # choices kept per token
    assert kept.max() <= k
    assert (kept.min() < k) == (capacity < 32), kept.min()   # drops


def test_moe_apply_matches_jax_with_drops():
    """``moe_apply`` (deepseek smoke config, capacity factor 0.5, so tokens
    overflow) against JAX on the same weights (the port's ``moe_params``
    from a seeded generator, handed to JAX as arrays): output within
    rtol = atol = 1e-5 and the aux loss within 1e-6."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro_torch.configs import get_config as tget
    from repro_torch.models import moe as tmoe

    jcfg = jget("deepseek-moe-16b", smoke=True).replace(capacity_factor=0.5)
    tcfg = tget("deepseek-moe-16b", smoke=True).replace(capacity_factor=0.5)
    p = tmoe.moe_params(torch.Generator().manual_seed(1), tcfg,
                        torch.float32)
    x = np.random.default_rng(12).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    jo, ja = jmoe.moe_apply(jax.tree.map(lambda a: jnp.asarray(a.numpy()), p),
                            jcfg, jnp.asarray(x))
    to, ta = tmoe.moe_apply(p, tcfg, torch.as_tensor(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
