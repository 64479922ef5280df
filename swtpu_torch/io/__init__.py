"""FASTA and base encoding: the port's copy of ``swtpu.io``."""

from swtpu_torch.io.encode import (
    BASE_CODES,
    CODE_BASES,
    decode_seq,
    encode_batch,
    encode_seq,
    pack_2bit,
    unpack_2bit,
)
from swtpu_torch.io.fasta import FastaRecord, read_fasta, read_query_and_db, write_fasta
from swtpu_torch.io.loader import EncodedDB, load_encoded

__all__ = [
    "FastaRecord",
    "read_fasta",
    "read_query_and_db",
    "write_fasta",
    "BASE_CODES",
    "CODE_BASES",
    "encode_seq",
    "decode_seq",
    "encode_batch",
    "pack_2bit",
    "unpack_2bit",
    "EncodedDB",
    "load_encoded",
]
