"""Model FLOPs of the window's steps over its time and the card's bf16
peak: 6 a matmul weight a token plus the causal attention products
(``yardstick.train_flops_per_token``), no recompute counted."""

import yardstick as ys

UNIT = "%"


def read(run):
    flops = ys.train_flops_per_token(run["cfg"], run["mix"]["seq_len"]) \
        * run["tokens_per_step"] * run["steps"]
    return 100.0 * flops / (run["window_s"] * ys.BF16_FLOPS * run["chips"])
