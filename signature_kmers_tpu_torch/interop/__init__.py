"""Reference on-disk store interop (pure numpy, with native C++ where the
host runtime builds).

The reference's production artifacts are a CMPH BDZ minimal-perfect-hash
``.mph`` plus a flat StoredKmerData value array (ref: cmph_kmer.h:95-104,
perfect_hash.h:57-63) and a NuDB ``.dat/.key/.log`` triple
(ref: nudb_kmer_db.h:32-63).  cmph.py reads and writes the CMPH pair;
nudb.py reads a NuDB store's data log, writes the .dat/.key pair and
fetches through the key file.
"""
