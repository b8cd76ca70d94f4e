"""Cells cut to the configurations' smoke sizes, for the CPU tests: the
same files, drivers and checks as the benchmark's cells, with small
widths and short traffic."""

import torch

from perfbench.lib import bench

SMOKE = {
    "rwkv6_3b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab_size=256, rwkv_head_dim=16),
    "qwen1_5_4b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=128, vocab_size=256),
}
TRAFFIC = {
    "score": dict(batch=2, seq=64),
    "train": dict(seq=64),
}
#: deeper and wider cuts for the control test: at the smoke sizes
#: float8's error does not yet reach the full-size limits it must fail
CONTROL = {
    "rwkv6_3b.score-4k": (dict(n_layers=12, d_model=256, d_ff=512,
                               rwkv_head_dim=64, vocab_size=2048),
                          dict(batch=1, seq=256, check_rows=1)),
    "qwen1_5_4b.train-2k": ({}, {}),
}
CPU = torch.device("cpu")


def cell(name: str, traffic=None, **model) -> bench.Cell:
    """``<config>.<traffic>`` from its files (``BENCHMARK.json`` need not
    hold it), cut to the smoke sizes."""
    config, mix = name.split(".", 1)
    c = bench.file_cell(name, bench.HERE / "configs" / f"{config}.json", mix)
    c.config["model"].update(SMOKE[c.config["name"]], **model)
    c.traffic.update(TRAFFIC[c.traffic["driver"]], **(traffic or {}))
    return c


def control_cell(name: str) -> bench.Cell:
    model, traffic = CONTROL[name]
    return cell(name, traffic, **model)
