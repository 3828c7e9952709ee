"""The port's LM ``encdec`` configs against the JAX package at smoke size:
seamless-m4t-large-v2: encoder, decoder with cross-attention over the encoder's hidden states, LayerNorm, ReLU and biases.

The harness and its tolerances are ``tests/_lm_parity.py``'s: forward
logits, loss and aux, prefill logits and cache, a decode step's logits and
cache, and the step past ``max_seq``, each within rtol = atol = 1e-5 of
JAX on JAX's own weights; the port's prefill -> decode against its own
forward within the JAX smoke test's 2e-4 / 2e-3.
"""

import pytest
import torch

from _lm_parity import (check_consistency, check_decode, check_forward,
                        check_past_max_seq, check_prefill, parity_results)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=['seamless-m4t-large-v2'])
def res(request):
    return parity_results(request.param)


def test_forward_matches_jax(res):
    check_forward(res)


def test_prefill_matches_jax(res):
    check_prefill(res)


def test_decode_step_matches_jax(res):
    check_decode(res)


def test_decode_past_max_seq_matches_jax(res):
    check_past_max_seq(res)


def test_prefill_decode_consistency(res):
    check_consistency(res)
