"""The port's test harness: seeded fault injection (``faults``) and the
reference's golden-file parsers (``goldens``); copies of
``swtpu.testing``'s modules of the same names."""

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
