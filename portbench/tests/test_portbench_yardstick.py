"""The frozen counting functions and generators against small cases
worked by hand."""

import numpy as np
import pytest
import torch

from portbench.yardstick import generate, images, peaks, work

# pixel sums of the 64x64 stand-ins when they were frozen
BARBARA_64_SUM = 394333.4181533692
LENA_64_SUM = 638806.4783217466


def test_bound_ms_picks_the_larger_bound():
    assert peaks.bound_ms(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    assert peaks.bound_ms(0.0, 67e9) == pytest.approx((1.0, "operations"))
    assert peaks.bound_ms(3.35e9, 2 * 67e9)[1] == "operations"
    assert peaks.bound_s(0.0, 2 * 3.35e9, chips=2) == pytest.approx(1e-3)


def test_share_pct():
    assert peaks.share_pct(67e9, 0.0, 0.004) == pytest.approx(25.0)
    assert peaks.share_pct(67e9, 0.0, 0.004, chips=4) == pytest.approx(6.25)
    assert peaks.share_pct(1.0, 0.0, 0.0) is None


def test_gram_omp_flops_by_hand():
    # one lane, no atom: ||x||^2 only (2p)
    assert work.gram_omp_flops(2, 3, [0], 0) == 4
    # one lane, one atom, p=2, K=3: G column 2pK=12, ||x||^2 4,
    # alpha0 12, step 1 (n=0): score K=3, cholesky 1/3, solves 2, err 2
    assert work.gram_omp_flops(2, 3, [1], 1) == pytest.approx(12 + 4 + 12
                                                              + 3 + 1 / 3
                                                              + 2 + 2)
    # two atoms add step 2 (n=1): 2K*1=6, K=3, n^2=1, 2n=2, 1/3,
    # 2*(2)^2=8, 2*2=4
    one = work.gram_omp_flops(2, 3, [1], 0)
    two = work.gram_omp_flops(2, 3, [2], 0)
    assert two - one == pytest.approx(6 + 3 + 1 + 2 + 1 / 3 + 8 + 4)


def test_gram_omp_flops_groups():
    # gs=2, one group: score 2K + K/gs, factor gs^3/3, solves 2 gs^2...
    p, K = 2, 4
    f = work.gram_omp_flops(p, K, [1], 0, gs=2)
    lane = 2 * p * K + (2 * K + K // 2) + 8 / 3 + 2 * 4 + 2 * 2
    assert f == pytest.approx(2 * p + lane)


def test_scale_nsel():
    out = work.scale_nsel([1, 1, 2, 2], 8)
    assert sorted(out.tolist()) == [1, 1, 1, 1, 2, 2, 2, 2]


def test_encode_call_and_kernel_by_hand():
    f, b = work.encode_call(2, 3, 1, np.array([1]), 1)
    assert f == pytest.approx(12 + 4 + 12 + 3 + 1 / 3 + 2 + 2)
    assert b == 4 * (2 + 6) + (2 * 4 + 8)
    fk, bk = work.omp_kernel(2, 3, 1, np.array([1]))
    assert fk == pytest.approx(f - 12)
    assert bk == 4 * (2 + 12 + 9) + 16


def test_denoise_call_and_ksvd_iteration_by_hand():
    nsel = np.array([0, 1])
    f, b = work.denoise_call(2, 3, 4, 4, nsel, 1)
    assert f == pytest.approx(work.gram_omp_flops(2, 3, nsel, 1) + 2 * 2)
    assert b == 4 * (2 * 16 + 6)
    assert work.ksvd_iteration(2, 3, nsel, 1) == pytest.approx(
        work.gram_omp_flops(2, 3, nsel, 1) + 10 * 2)


def test_images_are_frozen():
    a = images.standard_test_image("barbara", 64)
    b = images.standard_test_image("barbara", 64)
    assert a.shape == (64, 64) and np.array_equal(a, b)
    assert a.min() == 0.0 and a.max() == pytest.approx(255.0)
    assert a.sum() == pytest.approx(BARBARA_64_SUM, rel=1e-12)
    assert images.standard_test_image("lena", 64).sum() == pytest.approx(
        LENA_64_SUM, rel=1e-12)
    with pytest.raises(ValueError):
        images.synthetic_image("nope", 8)


def test_generator_repeats_and_differs():
    dev = torch.device("cpu")
    big = 2**31 + 977
    a = generate.unit_gaussian_dictionary(8, 5, generate.generator(big, dev),
                                          dev)
    b = generate.unit_gaussian_dictionary(8, 5, generate.generator(big, dev),
                                          dev)
    c = generate.unit_gaussian_dictionary(8, 5, generate.generator(big + 1,
                                                                   dev), dev)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.allclose(torch.linalg.vector_norm(a, dim=0),
                          torch.ones(5))
    clean = generate.clean_images(["barbara", "lena"], 16)
    pool = generate.noisy_pool(clean, 25.0, 3, generate.generator(1, dev),
                               dev)
    assert pool[2].shape == (16, 16) and not torch.equal(pool[0], pool[2])
    # pool entries 0 and 2 share barbara: their mean difference is noise
    assert abs(float((pool[0] - pool[2]).mean())) < 25.0
    s = generate.sample_indices(big, 1, 10, 4)
    assert len(set(s.tolist())) == 4 and s.max() < 10
    assert np.array_equal(s, generate.sample_indices(big, 1, 10, 4))


def test_percentile_by_nearest_rank():
    from portbench.core.readers import percentile

    v = [5.0, 1.0, 4.0, 2.0, 3.0] * 4 + [100.0]        # 21 values
    assert percentile(v, 50) == 3.0
    assert percentile(v, 95) == 5.0                  # rank 20 of 21
    assert percentile(v, 96) == 100.0                # rank 21
    assert percentile([7.0], 95) == 7.0
