"""The seeded inputs: the same seed gives the same arrays, another seed
others, and every seed the same sizes."""

import numpy as np

from benchmark import harness, inputs

from ._small import small_cell

REF = harness.reference_of(small_cell("bl3_run"))


def _cfg():
    return REF.config.config_from_dict(small_cell("bl3_run").namelist)


def test_same_seed_same_arrays():
    a = inputs.seeded_state(REF, _cfg(), 2**33 + 5)
    b = inputs.seeded_state(REF, _cfg(), 2**33 + 5)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_seeds_differ_in_pott_and_qv_only():
    a = inputs.seeded_state(REF, _cfg(), 1)
    b = inputs.seeded_state(REF, _cfg(), 2)
    assert {k for k in a if a[k].shape != b[k].shape} == set()
    assert {k for k in a if not np.array_equal(a[k], b[k])} == {"pott",
                                                                "qv"}
    assert 0.05 < np.std(a["pott"] - b["pott"]) < 0.2


def test_compared_chunk_in_the_window():
    got = {inputs.compared_chunk(s, 5) for s in range(200)}
    assert got == {1, 2, 3, 4, 5}
    assert inputs.compared_chunk(3_000_000_001, 7) == \
        inputs.compared_chunk(3_000_000_001, 7)
