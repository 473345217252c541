"""benchmark/work.py against counts worked by hand: one convolution, one
int8 block, one retrieval, and the RN50 trunk's convolutions."""

import json
import os

import pytest

from benchmark import work

HERE = os.path.dirname(os.path.abspath(__file__))


def rn50():
    with open(os.path.join(HERE, "..", "configs", "rn50.json")) as f:
        return json.load(f)


def test_bench_conv_work_by_hand():
    # x [1, 8, 8, 4] * k [16, 4, 3, 3], stride 1: 64 outputs x 16 channels x
    # K = 36 multiply-adds; bf16 bytes of input 256, weight 576, output 1024
    ops, nbytes = work.conv_work((1, 8, 8, 4), (16, 4, 3, 3), 1)
    assert ops == 2 * 64 * 16 * 36 == 73728
    assert nbytes == 2 * (256 + 576 + 1024)
    # stride 2 over a 7x7 grid gives 4x4 outputs (ceil), fp32 elements
    ops, nbytes = work.conv_work((2, 7, 7, 8), (8, 8, 1, 1), 2, elem=4)
    assert ops == 2 * 32 * 8 * 8
    assert nbytes == 4 * (2 * 49 * 8 + 64 + 32 * 8)


def test_bench_bound_takes_the_longer_side():
    assert work.bound_s(989e12, 0, "bf16") == pytest.approx(1.0)
    assert work.bound_s(1.0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert work.bound_s(67e12, 3.35e12, "fp32") == pytest.approx(1.0)
    assert work.bound_s(1979e12, 0, "int8") == pytest.approx(1.0)


def test_bench_int8_block_by_hand():
    # 2 sequences of 4 tokens at D 128, H 512: R = 8 rows
    w = work.int8_layer_work(8, 2, 4, 128, 512)
    i8, b16, nbytes = w["attn_block_int8"]
    assert i8 == 6 * 8 * 128 * 128 == 786432
    assert b16 == 2 * 8 * 128 * 128 + 4 * 2 * 128 * 16 == 278528
    assert nbytes == 4 * 8 * 128 + 5 * 128 * 128 == 86016
    i8, b16, nbytes = w["mlp_int8"]
    assert (i8, b16) == (4 * 8 * 128 * 512, 0)
    assert nbytes == 4 * 8 * 128 + 2 * 128 * 512
    assert w["ln_quant"][2] == 2 * (3 * 8 * 128 + 4 * 8)


def test_bench_retrieval_by_hand():
    assert work.retrieval_flops(3, 5, 4) == 2 * 3 * 5 * 4
    # a batch of 8 images x 305 crops against 220k rows at 1024-d
    assert work.retrieval_flops(2440, 220000, 1024) == pytest.approx(1.0995e12, rel=1e-3)


def test_bench_rn50_trunk_has_55_convolutions_and_matches_the_tower_count():
    cfg = rn50()
    convs = work.rn_convs(cfg, 1)
    assert len(convs) == 55
    assert sum(r for *_, r in convs) == 16          # one residual a bottleneck
    trunk = sum(work.conv_work(x, k, s)[0] for x, k, s, _ in convs)
    # the tower count adds the pool and the dense projection to the same trunk
    e, t, grid = 2048, 50, 7
    head = (2 * (2 * t + 1) * e * e + 2 * e * 1024 + 4 * t * e
            + 2 * grid * grid * (e * e + e * 1024))
    assert work.rn_tower_flops(cfg) == pytest.approx(trunk + head, rel=1e-12)


def test_bench_resize_counts_the_taps():
    # a 224-side crop needs 4 taps an output on each axis
    assert work.resize_flops([224]) == 2 * (224 * 4 * 224 * 3 + 224 * 224 * 3 * 4)
    # a 448-side crop widens the support to 8 taps
    assert work.resize_flops([448]) == 2 * (224 * 8 * 448 * 3 + 224 * 224 * 3 * 8)


def test_bench_train_step_count_grows_with_the_batch():
    cfg = rn50()
    one, two = work.train_step_flops(cfg, 1024, 2, False), work.train_step_flops(cfg, 2048, 2, False)
    assert two > one
    # the caption branch alone: 12 layers x 24 t d^2 a caption plus the causal
    # pairs and the projection at every position
    cap = 1024 * (12 * 24 * 77 * 512 ** 2 + 12 * 4 * 512 * 77 * 78 / 2 + 2 * 512 * 1024 * 77)
    assert cap < one < 2 * cap
