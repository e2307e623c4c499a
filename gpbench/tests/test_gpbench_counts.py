"""The yardstick's counts against values reckoned by hand at small
shapes."""

import json
import os

import pytest

from gpbench import peaks
from gpbench.counts import Work, dgp, k1, k2, k5, k6, k8

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_k1_one_point():
    # M = 2, Din = 1, D = 1: tri = 3; products z.x 4, A 6, b 6, mean 4 = 20;
    # other ||x||^2 2, sq and kuf 14, t2 4, var 2 = 22, ||z||^2 4
    w = k1.work(1, 2, 1, 1)
    assert w.products == 20
    assert w.other == 22 + 4
    # X 1, mean and var 2, Pinv 3, Z 2, v 1, q_mu 2, Sq 3
    assert w.bytes == 4 * 14


def test_k2_counts_the_recomputed_forward():
    w = k2.work(1, 2, 1, 1)
    # 6 M Din = 12, 6 tri = 18, 6 D tri = 18, 4 M D = 8
    assert w.products == 56
    assert w.other == 4 + 30 + 8 + 2
    small = 3 + 2 + 1 + 2 + 3
    assert w.bytes == 4 * (1 + 2 + small + 1 + small)


def test_quadform_counts_triangles():
    assert k5.work(10, 4, 2).products == 10 * 2 * 2 * 10
    assert k5.work(10, 4, 2, with_t1=True).other == 10 * (16 + 8)
    assert k6.work(10, 4, 2).products == 3 * k5.work(10, 4, 2).products
    assert k8.work(2, 3).products == 2 * 2 * 27 / 3


def test_work_prices_products_at_3xtf32():
    assert peaks.PRODUCT_FLOPS == pytest.approx(165e12)
    assert Work(165e12, 0, 0).seconds() == pytest.approx(1.0)
    assert Work(0, 67e12, 0).seconds() == pytest.approx(1.0)
    # bytes bound where they take longer than the operations
    assert Work(1.0, 0, 3.35e12).seconds() == pytest.approx(1.0)


def config(white=True, **kw):
    with open(os.path.join(HERE, "configs", "dgp2_white_rbf.json")) as f:
        c = json.load(f)
    c.update(white=white, **kw)
    return c


def test_layer_one_counts_distinct_rows():
    c = config(num_inducing=4, num_samples=10)
    per_row_layer1 = dgp._conditional(1, 4, 8, 8, True)
    # doubling S adds nothing to layer 1's conditional, only to what
    # follows it (the samples and layer 2)
    a, b = dgp.request(c, 100), dgp.request(dict(c, num_samples=20), 100)
    layer2 = dgp._conditional(10 * 100, 4, 8, 1, True)
    samples = Work(0, 4 * 10 * 100 * 8)
    tail = Work(0, 6 * 10 * 100)
    assert b.products - a.products == pytest.approx(layer2.products)
    assert b.other - a.other == pytest.approx(
        layer2.other + samples.other + tail.other)
    assert per_row_layer1.products == 2 * 4 * 8 + 2 * 10 + 2 * 8 * 10 + 2 * 4 * 8


def test_request_by_hand():
    # one layer, M = 2, Din = 1, D = 1, S = 3, white: the conditional at
    # R = 5 distinct rows plus Kuu and its factor, then the likelihood and
    # the moment matching at S R
    c = config(num_inducing=2, num_samples=3, input_dim=1, hidden_dims=[],
               output_dim=1, mean_functions=["zero"])
    w = dgp.request(c, 5)
    products = 5 * 20 + (2 * 3 * 1 + 2 * 8 / 3)
    other = 5 * (2 + 14 + 4 + 2) + 5 * 3 + 3 * 5 + 5 * 3 * 5 + 2 * 5
    assert w.products == pytest.approx(products)
    assert w.other == pytest.approx(other)
    assert w.bytes == 4 * (5 * 1 + 2 * 5)


def test_training_step_grows_with_the_rows_not_the_parameters():
    c = config()
    a, b = dgp.train_step(c, 10_000), dgp.train_step(c, 20_000)
    assert b.products == pytest.approx(2 * a.products, rel=1e-3)
    assert dgp.num_parameters(c) == (1 + 8 + 128 * 8 + 128 * 8 + 8 * 128 ** 2
                                     + 1 + 8 + 128 * 8 + 128 + 128 ** 2 + 1)
