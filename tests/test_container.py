"""ATFC self-describing container + `python -m lane_ans` CLI."""

import numpy as np
import pytest

from lane_ans import container
from lane_ans.__main__ import main as cli


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return np.minimum(rng.zipf(1.3, size=20000) - 1, 1 << 20).astype(
        np.uint32)


@pytest.mark.parametrize("method,engine", [
    ("ANSfold-2", "lane"), ("ANSfold-2", "compat"), ("ANS", "lane"),
    ("ANSmsb", "compat"), ("vbyte", "lane"), ("shuff", "compat"),
])
def test_container_roundtrip(data, method, engine):
    buf = container.compress(data, method, engine)
    m, e, n, _ = container.unpack(buf)
    assert (m, e, n) == (method, engine, len(data))
    np.testing.assert_array_equal(container.decompress(buf), data)


def test_container_rejects_corruption(data):
    buf = bytearray(container.compress(data, "ANSfold-2", "compat"))
    with pytest.raises(ValueError):
        container.unpack(buf[:5])
    with pytest.raises(ValueError):
        container.unpack(b"\x00" * 32)
    bad = bytearray(buf)
    bad[4] = 9  # version
    with pytest.raises(ValueError):
        container.unpack(bad)
    with pytest.raises(ValueError):
        container.unpack(buf[: len(buf) // 2])  # truncated payload


def test_cli_roundtrip(data, tmp_path, capsys):
    src = tmp_path / "in.u32"
    data.astype("<u4").tofile(src)
    atfc = tmp_path / "out.atfc"
    dst = tmp_path / "out.u32"
    assert cli(["compress", str(src), str(atfc), "-m", "ANSmsb"]) == 0
    assert cli(["info", str(atfc)]) == 0
    assert "method=ANSmsb" in capsys.readouterr().out
    assert cli(["decompress", str(atfc), str(dst)]) == 0
    np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"), data)


def test_cli_text_input(tmp_path):
    src = tmp_path / "in.txt"
    src.write_text("5 1 2 3 4\n5 6\n")
    atfc = tmp_path / "t.atfc"
    dst = tmp_path / "t.u32"
    assert cli(["compress", "-t", str(src), str(atfc)]) == 0
    assert cli(["decompress", str(atfc), str(dst)]) == 0
    np.testing.assert_array_equal(
        np.fromfile(dst, dtype="<u4"),
        np.array([5, 1, 2, 3, 4, 5, 6], dtype=np.uint32))


def test_cli_blocked_roundtrip(data, tmp_path, capsys):
    """--blocked writes an ATFB container via the block runtime; the
    CLI sniffs the magic and rebuilds the codec + mesh from the
    header (conftest provides the 8 virtual devices)."""
    src = tmp_path / "in.u32"
    data.astype("<u4").tofile(src)
    atfb = tmp_path / "out.atfb"
    dst = tmp_path / "out.u32"
    assert cli(["compress", str(src), str(atfb), "-m", "ANSfold-2",
                "--blocked", "-D", "4"]) == 0
    assert cli(["info", str(atfb)]) == 0
    out = capsys.readouterr().out
    assert "container=ATFB" in out and "D=4" in out
    assert cli(["decompress", str(atfb), str(dst)]) == 0
    np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"), data)


def test_cli_methods_lists_registry(capsys):
    assert cli(["methods"]) == 0
    out = capsys.readouterr().out.split()
    assert "ANSfold-2" in out and "shuff" in out
