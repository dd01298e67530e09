"""Driver-layer integration tests: every experiment CLI runs end-to-end
on tiny data (the reference's drivers are its only integration harness;
SURVEY.md section 2.5)."""

import os

import numpy as np
import pytest

from lane_ans.utils import io


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(0)
    v = (rng.zipf(1.3, size=4000) - 1).clip(0, 1 << 20).astype(np.uint32)
    io.write_file_u32(os.path.join(d, "zipfy.u32"), v)
    return str(d)


def test_generate_inputs(tmp_path):
    from lane_ans.drivers import generate_inputs
    files = generate_inputs.generate_all(str(tmp_path), 500)
    assert len(files) == 14
    for f in files:
        assert len(io.read_file_u32(f)) == 500


def test_table_effectiveness(data_dir, capsys):
    from lane_ans.drivers import table_effectiveness
    table_effectiveness.main(
        ["-i", data_dir, "--methods", "vbyte,ANSmsb,entropy_only",
         "--engine", "compat"])
    out = capsys.readouterr().out
    assert out.count("\\method") == 3


def test_table_efficiency(data_dir, capsys):
    from lane_ans.drivers import table_efficiency
    table_efficiency.main(["-i", data_dir, "--methods", "vbyte,ANSfold-1",
                           "--engine", "compat", "--runs", "1"])
    assert "\\method{ANSfold-1}" in capsys.readouterr().out


def test_benchmark_driver(data_dir, capsys):
    from lane_ans.drivers import benchmark
    benchmark.main(["-i", data_dir, "--methods", "ANSmsb,shuff",
                    "--engine", "compat", "--runs", "1"])
    out = capsys.readouterr().out
    assert "ANSmsb" in out and "shuff" in out


def test_fold_effectiveness(data_dir, capsys):
    from lane_ans.drivers import fold_effectiveness
    from lane_ans.drivers._cli import load_inputs

    class A:
        input = data_dir + "/zipfy.u32"
        text = False

    rows = fold_effectiveness.run(load_inputs(A), "compat")
    assert len(rows) == 16  # fold 1..8 + rfold 1..8


def test_bucket_skew(data_dir, capsys):
    from lane_ans.drivers import bucket_skew
    v = io.read_file_u32(data_dir + "/zipfy.u32")
    rows = bucket_skew.compute_skew(v, "zipfy", 2)
    assert rows and all(r[2] == 2 for r in rows)
    # usage sums to n
    assert sum(r[6] for r in rows) == len(v)


def test_rescale_freqs(data_dir, capsys):
    from lane_ans.drivers import rescale_freqs
    v = io.read_file_u32(data_dir + "/zipfy.u32")[:2000]
    rows = rescale_freqs.rescale_study(v, "zipfy")
    assert len(rows) == 31


def test_lower_order_entropy(data_dir, capsys):
    from lane_ans.drivers import lower_order_entropy
    v = io.read_file_u32(data_dir + "/zipfy.u32")
    lower_order_entropy.run(v, "zipfy")
    assert len(capsys.readouterr().out.splitlines()) == 32


def test_prelude_driver(data_dir, capsys):
    from lane_ans.drivers import prelude
    v = io.read_file_u32(data_dir + "/zipfy.u32")
    prelude.run(v, "zipfy", "compat")
    assert "prelude_bytes" in capsys.readouterr().out


def test_pseudo_adaptive_driver(data_dir, capsys):
    from lane_ans.drivers import pseudo_adaptive
    from lane_ans.drivers._cli import load_inputs

    class A:
        input = data_dir + "/zipfy.u32"
        text = False

    rows = pseudo_adaptive.run(load_inputs(A), max_i=3)
    assert rows and all(len(r) == 4 for r in rows)


def test_shuff_driver(data_dir, capsys):
    from lane_ans.drivers import shuff
    shuff.main(["-i", data_dir + "/zipfy.u32"])
    assert "bpi=" in capsys.readouterr().out


def test_generate_bwtmtf_driver(tmp_path):
    from lane_ans.drivers import generate_bwtmtf
    src = tmp_path / "text.txt"
    src.write_bytes(b"the quick brown fox jumps over the lazy dog " * 40)
    out = tmp_path / "ranks.u32"
    generate_bwtmtf.main(["-i", str(src), "-o", str(out)])
    ranks = io.read_file_u32(str(out))
    assert len(ranks) == len(src.read_bytes())


def test_generate_rlz():
    from lane_ans.drivers.generate_rlz import (rlz_factorize,
                                              rlz_reconstruct)
    rng = np.random.default_rng(1)
    base = rng.integers(0, 30, 2000).astype(np.uint8)
    text = np.concatenate([base[50:400], base[900:1500],
                           rng.integers(0, 255, 30).astype(np.uint8)])
    lens, offs = rlz_factorize(text, base)
    np.testing.assert_array_equal(rlz_reconstruct(lens, offs, base), text)
    # the factor streams are the experiment datasets (rlz-d64 analogues)
    assert lens.dtype == np.uint32 and offs.dtype == np.uint32
