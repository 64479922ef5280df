"""The port's test harness: seeded fault injection (``faults``) and the
reference's golden-file parsers (``goldens``), copies of
``swtpu.testing``'s modules of the same names; the localhost multi-process
harness (``worker``, ``regress``); and the config-driven regression suites
(``suite``: ``run_suite``, and ``main_cli`` behind the CLI's ``regress``)."""

from swtpu_torch.testing.goldens import (
    REFERENCE_DATA_DIR,
    parse_rtl_out_file,
    parse_ssearch_scores,
    reference_data_available,
)

__all__ = [
    "REFERENCE_DATA_DIR",
    "parse_rtl_out_file",
    "parse_ssearch_scores",
    "reference_data_available",
]
