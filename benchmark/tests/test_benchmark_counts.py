"""The work counts and the cells' geometry against hand arithmetic, at
both configurations' shapes."""

import json
import os

import pytest

from conftest import BENCH_DIR
from counts import lr
from reference import draws


def _cfg(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def test_higgs_step_by_hand():
    # 1,025 blocks of 1,024 rows; 28 features + bias, + label: 30 bf16
    rows = 1025 * 1024
    ops, nbytes = lr.sgd_work(28, "bfloat16", rows, 1)
    assert ops == 4 * 1_049_600 * 29 == 121_753_600
    assert nbytes == 1_049_600 * 30 * 2 + 2 * 4 * 29 == 62_976_232
    pk = lr.peaks("NVIDIA H100 80GB HBM3")
    assert lr.bound_s(ops, nbytes, pk) == pytest.approx(18.799e-6, rel=1e-4)


def test_epsilon_step_by_hand():
    rows = 39 * 1024
    ops, nbytes = lr.sgd_work(2000, "bfloat16", rows, 1)
    assert ops == 4 * 39_936 * 2001 == 319_647_744
    assert nbytes == 39_936 * 2002 * 2 + 8 * 2001 == 159_919_752
    pk = lr.peaks("NVIDIA H100 80GB HBM3")
    # bytes bind: 47.7 µs against 4.8 µs of float32 arithmetic
    assert lr.bound_s(ops, nbytes, pk) == pytest.approx(47.737e-6, rel=1e-4)
    assert ops / pk["fp32_flops_per_s"] < nbytes / pk["hbm_bytes_per_s"]


def test_steps_add_weight_traffic_only():
    one = lr.sgd_work(28, "bfloat16", 1000, 1)
    two = lr.sgd_work(28, "bfloat16", 2000, 2)
    assert two[0] == 2 * one[0] and two[1] == 2 * one[1]


def test_unknown_card_has_no_peaks():
    assert lr.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert lr.peaks("cpu") is None


@pytest.mark.parametrize("config,replicas,blocks,sampled,padded", [
    ("higgs-lr", 1, 10254, 1025, 10_500_096),
    ("epsilon-lr", 1, 391, 39, 400_384),
    ("higgs-lr", 4, 2564, 256, 10_502_144),
])
def test_cell_geometry(config, replicas, blocks, sampled, padded):
    n = _cfg(config)["n_train"]
    assert draws.padded_rows(n, 1024, replicas) == padded
    nb = draws.blocks_per_replica(n, 1024, replicas)
    assert nb == blocks
    assert draws.sampled_blocks(nb, 0.1) == sampled


def test_valid_rows_exclude_padding():
    v = draws.valid_rows_per_block(10_500_000, 1024, 10_256, "cpu")
    assert int(v.sum()) == 10_500_000
    assert v[10_252].item() == 1024 and v[10_253].item() == 928
    assert v[10_254].item() == 0 and v[10_255].item() == 0
