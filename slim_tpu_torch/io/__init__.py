from .readers import (
    read_matrix,
    write_matrix,
    read_csr,
    write_csr,
    read_cluto,
    write_cluto,
    read_ijv,
    write_ijv,
    read_binrow,
    write_binrow,
    FORMATS,
)

__all__ = [
    "read_matrix", "write_matrix", "read_csr", "write_csr", "read_cluto",
    "write_cluto", "read_ijv", "write_ijv", "read_binrow", "write_binrow",
    "FORMATS",
]
