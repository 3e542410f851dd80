"""The benchmark's frozen counters against counts made by hand."""
import pytest

from bench import counts

TINY = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 4, "num_hidden_layers": 3,
        "vocab_size": 10, "sliding_window": None}


@pytest.mark.parametrize("sq,skv,causal,window,want", [
    (4, 4, True, 0, 10),          # 1 + 2 + 3 + 4
    (4, 4, False, 0, 16),
    (5, 5, True, 2, 9),           # 1 + 2 + 2 + 2 + 2
    (3, 5, True, 0, 6),           # queries 0..2 see 1, 2, 3 keys
    (1, 1, True, 4096, 1),
])
def test_visible_pairs(sq, skv, causal, window, want):
    assert counts.visible_pairs(sq, skv, causal, window) == want


@pytest.mark.parametrize("tokens,window", [(1, 0), (7, 0), (7, 3), (7, 7),
                                           (7, 100)])
def test_causal_keys_is_visible_pairs_of_a_square(tokens, window):
    assert counts.causal_keys(tokens, window) == counts.visible_pairs(
        tokens, tokens, True, window)


def test_flash_bound_by_hand():
    # 2 heads of 1 kv head, 4 queries and keys, hd 4, bf16
    flops = 4 * 4 * 2 * 10
    assert counts.flash_flops(2, 4, 4, 4, True, 0) == flops
    nbytes = 2 * 4 * (2 * 2 * 4 + 2 * 1 * 4)
    assert counts.flash_bytes(2, 1, 4, 4, 4, 2) == nbytes
    assert counts.flash_bound_s(2, 1, 4, 4, 4, True, 0, 2) == max(
        flops / 989e12, nbytes / 3.35e12)


def test_request_flops_dense_by_hand():
    # per layer a token: q 8x8, k and v 8x4 each, o 8x8, SwiGLU 3 x 8x16
    per_token = 2 * (64 + 32 + 32 + 64) + 2 * 3 * 128
    assert counts.layer_matmul_flops_per_token(TINY) == per_token
    prompt, new = 5, 3
    tokens = 7                    # the last generated token is not fed back
    attn = 4 * 4 * 2 * (7 * 8 // 2)
    head = 2 * 8 * 10 * 3
    assert counts.request_flops(TINY, prompt, new) == \
        3 * (per_token * tokens + attn) + head


def test_request_flops_moe_by_hand():
    arch = {**TINY, "num_local_experts": 4, "num_experts_per_tok": 2,
            "sliding_window": 3}
    per_token = 2 * (64 + 32 + 32 + 64) + 2 * (8 * 4 + 2 * 3 * 128)
    assert counts.layer_matmul_flops_per_token(arch) == per_token
    attn = 4 * 4 * 2 * (1 + 2 + 3 + 3 + 3 + 3 + 3)
    assert counts.request_flops(arch, 5, 3) == \
        3 * (per_token * 7 + attn) + 2 * 8 * 10 * 3
