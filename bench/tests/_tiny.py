"""Tiny cells that the CPU tests run through the whole harness."""
import time

from bench import harness

CONFIG = {"engine": "embedding", "d_model": 37,
          "serve": {"capacity": 1024, "retrieve_k": 5, "contract": "Q16.16",
                    "route": "auto", "ef": 16, "ef_coarse": 0,
                    "exact_threshold": 48}}
DATA = {"kind": "mixture", "clusters": 8, "latent": 6, "spread": 1.0,
        "noise": 0.1}
MIXES = {
    "stream": {"fill_rows": 96, "fill_batch": 32,
               "cycle": [{"op": "ingest", "n": 32},
                         {"op": "read", "n": 6, "k": 5},
                         {"op": "read", "n": 6, "k": 5}],
               "data": DATA, "check": {"beam_reads": 2, "score_reads": 16}},
    "search": {"fill_rows": 96, "fill_batch": 32,
               "cycle": [{"op": "read", "n": 8, "k": 5}],
               "data": DATA, "check": {"beam_reads": 1, "score_reads": 4}},
}


def cell(mix, config=CONFIG) -> harness.Cell:
    """A tiny cell of this mix (a name in MIXES or a mix), under every
    metric of the benchmark: a metric with nothing to read is left out."""
    bench = harness.load_benchmark()
    mix = MIXES[mix] if isinstance(mix, str) else mix
    return harness.Cell("tiny", config, mix, 1, bench["end_to_end"],
                        bench["per_layer"])


def run(mix, seed: int = 2**33 + 7, trace: bool = False,
        control: bool = False, seconds: float = 0.05, log=None) -> dict:
    from bench.run import run_cell
    import io
    return run_cell(cell(mix), seed, seconds, trace, "cpu", time.time(),
                    control=control, log=log or io.StringIO())


LM_CONFIG = {
    "engine": "lm_moe",
    "port": "granite_moe_3b_a800m",
    "num_hidden_layers": 4, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 32,
    "num_local_experts": 8, "num_experts_per_tok": 2, "vocab_size": 512,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "serve": {"capacity": 256, "retrieve_k": 4, "contract": "Q16.16",
              "route": "auto", "ef": 16, "ef_coarse": 0,
              "exact_threshold": 64, "context_tokens": 8, "s_cache": 64,
              "max_new_tokens": 4},
    "check_limits": {"embed_gap_p50": 0.05, "embed_gap_p90": 0.06,
                     "embed_gap_p99": 0.08}}
LM_MIX = {"fill_rows": 12, "fill_batch": 12,
          "cycle": [{"op": "ingest", "n": 12}],
          "data": {"kind": "tokens", "length": 16, "vocab": 512},
          "check": {"beam_reads": 0, "score_reads": 0}}


def run_lm(seed: int = 2**33 + 9, control: bool = False,
           seconds: float = 0.05) -> dict:
    """The granite cell at the port's REDUCED granite config."""
    from unittest import mock
    from bench.run import run_cell
    from repro_torch import configs
    import io
    with mock.patch.object(configs, "get_config",
                           configs.get_reduced_config):
        return run_cell(cell(LM_MIX, LM_CONFIG), seed, seconds, False,
                        "cpu", time.time(), control=control,
                        log=io.StringIO())
