"""The corrector and its physics epilogue, counted as one substep
(``substep_kernel<false>`` and ``epilogue_kernel``), share of their
roofline, in %."""

from benchmark.readers import share


def read(run: dict):
    return share(run, "corrector", ("substep_kernel<false>",
                                    "epilogue_kernel"))
