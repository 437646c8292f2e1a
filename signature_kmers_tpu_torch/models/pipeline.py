"""Open a built signature data dir for calling."""

from __future__ import annotations

from pathlib import Path

from ..io import formats
from ..table.wide_table import WideKmerTable


def load_data_dir(data_dir):
    """Open a data dir -> (table, function_index).

    Reads this framework's own store, ``kmer_data.{npz,json}`` in the wide
    layout (either wide format), plus ``function.index``; a dir written by
    ``skt build-signatures`` loads as it is.  The other stores (cuckoo and
    linear layouts, reference CMPH/NuDB stores, a bare final.kmers) raise
    until a later slice of the port adds their layouts.
    """
    data_dir = Path(data_dir)
    base = data_dir / "kmer_data"
    if not WideKmerTable.exists(base):
        raise NotImplementedError(
            f"{data_dir}: no wide-layout kmer_data.{{npz,json}}; the other "
            "table layouts and reference stores come in a later slice of "
            "the PyTorch port")
    table = WideKmerTable.load(base)
    function_index = formats.read_function_index(data_dir / "function.index")
    return table, function_index
