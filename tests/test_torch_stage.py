"""``query_vectors``' contract on its plain route (the CPU's): what the
card's direct route (``csrc/stage_rows.cu``) must match bit for bit.

Rows of Python floats round as numpy's float64 -> float32 cast does (ties
to even, subnormals, NaN, infinities, doubles beyond float32's range to
infinity); padding components and padding rows are zeros; a row may be a
tuple, a list, a numpy array, or hold ints or numpy scalars; a row longer
than the width raises.  The caller's span counts the rows given, none of
them direct on the CPU.  ``tests/test_torch_card.py`` holds the card's
route to this one.
"""

import math
import struct
import types

import numpy as np
import pytest
import torch

from repro_torch.core.query.exec import query_vectors

CPU = types.SimpleNamespace(device=torch.device("cpu"))
FLT_MAX = float(np.finfo(np.float32).max)
HALF_ULP_ABOVE_MAX = 2.0**128 - 2.0**103  # ties to even: up to 2**128, inf


def f32_bits(x: float) -> int:
    """The float32 bits of ``x`` rounded to nearest, ties to even
    (``struct``'s rounding; it raises past float32's range)."""
    return struct.unpack("<I", struct.pack("<f", x))[0]


# (double, float32 bits it rounds to)
ROUNDINGS = [
    (1.0 + 2.0**-24, 0x3F800000),  # a tie: down to the even 1.0
    (1.0 + 3 * 2.0**-24, 0x3F800002),  # a tie: up to the even neighbour
    (1.0 + 2.0**-24 + 2.0**-40, 0x3F800001),  # past the tie: up
    (-(1.0 + 2.0**-24), 0xBF800000),
    (0.1, f32_bits(0.1)),
    (-0.0, 0x80000000),
    (2.0**-149, 0x00000001),  # the least subnormal
    (1.5 * 2.0**-149, 0x00000002),  # a tie between subnormals: the even one
    (2.0**-150, 0x00000000),  # a tie between 0 and the least subnormal
    (2.0**-150 + 2.0**-170, 0x00000001),
    (-(2.0**-149), 0x80000001),
    (1e-40, f32_bits(1e-40)),
    (5e-324, 0x00000000),  # the least double subnormal
    (1.17549435e-38, f32_bits(1.17549435e-38)),  # about the least normal
    (FLT_MAX, 0x7F7FFFFF),
    (HALF_ULP_ABOVE_MAX - 2.0**80, 0x7F7FFFFF),  # beyond FLT_MAX, under the tie
    (HALF_ULP_ABOVE_MAX, 0x7F800000),
    (1e39, 0x7F800000),
    (-1e300, 0xFF800000),
    (math.inf, 0x7F800000),
    (-math.inf, 0xFF800000),
]


class Counts:
    """A span stand-in that keeps what ``count`` gave."""

    def __init__(self):
        self.counts = {}

    def count(self, **counts):
        self.counts.update(counts)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def test_rounding_to_float32_bits():
    """Each double of ``ROUNDINGS`` lands on its float32 bits, and NaN
    stays a NaN, in one row padded to a width past its length."""
    row = tuple(x for x, _ in ROUNDINGS) + (math.nan,)
    got = bits(query_vectors(CPU, [row], 1, len(row) + 5))[0]
    want = [b for _, b in ROUNDINGS]
    assert [hex(b) for b in got[: len(want)]] == [hex(b) for b in want]
    assert math.isnan(np.uint32(got[len(want)]).view(np.float32))
    assert not got[len(row):].any()


def test_random_doubles_round_as_numpy_casts():
    """Every bit pattern of a double, NaNs and out-of-range ones included,
    rounds as numpy's float64 -> float32 cast of the same values."""
    rng = np.random.default_rng(30)
    doubles = rng.integers(0, 2**64, size=(6, 50), dtype=np.uint64).view(np.float64)
    with np.errstate(over="ignore"):
        want = doubles.astype(np.float32)
    got = query_vectors(CPU, [tuple(r.tolist()) for r in doubles], 6, 50)
    np.testing.assert_array_equal(bits(got), want.view(np.uint32))


@pytest.mark.parametrize("rows", [3, 8])
def test_padding_components_and_rows_are_zero(rows):
    vectors = [(1.5, -2.25), (3.0,), ()]
    got = query_vectors(CPU, vectors, rows, 4)
    assert got.dtype == torch.float32 and got.shape == (rows, 4)
    want = np.zeros((rows, 4), np.uint32)
    want[0, :2] = [f32_bits(1.5), f32_bits(-2.25)]
    want[1, 0] = f32_bits(3.0)
    np.testing.assert_array_equal(bits(got), want)


ROW_FORMS = {
    "tuple": (0.5, -1.25, 3.0),
    "list": [0.5, -1.25, 3.0],
    "float64_array": np.array([0.5, -1.25, 3.0]),
    "float32_array": np.array([0.5, -1.25, 3.0], np.float32),
    "ints": (1, -2, 3),
    "numpy_scalars": (np.float64(0.5), np.float32(-1.25), np.int64(3)),
    "mixed": (0.5, -1, np.float64(3.0)),
}


@pytest.mark.parametrize("form", sorted(ROW_FORMS))
def test_row_forms(form):
    """Each form of a row stages as the float32 of its values."""
    row = ROW_FORMS[form]
    sp = Counts()
    got = query_vectors(CPU, [row, (7.0, 8.0)], 2, 4, sp)
    want = np.zeros((2, 4), np.float32)
    want[0, :3] = np.asarray(row, np.float64)
    want[1, :2] = 7.0, 8.0
    np.testing.assert_array_equal(bits(got), want.view(np.uint32))
    assert sp.counts == {"rows": 2, "direct_rows": 0}


@pytest.mark.parametrize("row", [(1.0,) * 5, [1.0] * 5, np.ones(5)],
                         ids=["tuple", "list", "array"])
def test_row_longer_than_width_raises(row):
    with pytest.raises(ValueError):
        query_vectors(CPU, [(1.0,), row], 2, 4)


def test_meta_makes_the_shape_only():
    got = query_vectors(types.SimpleNamespace(device=torch.device("meta")),
                        [(1.0, 2.0)], 4, 8)
    assert got.device.type == "meta" and got.shape == (4, 8)
    assert got.dtype == torch.float32
