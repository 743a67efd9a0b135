"""Mean `block_lna` span a block: `features_range` over the running
sample buffer and `lna_log_probs` (K2 + K1), ending in a synchronize,
in ms.
Layer: frontend + scoring per block.  Moves: `block_ms_p90`."""


def read(run):
    m = run.spans.mean("block_lna")
    return None if m is None else 1e3 * m
