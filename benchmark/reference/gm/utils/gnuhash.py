# Frozen copy of glimmer_mg_torch/utils/gnuhash.py at commit ab5a5d3.
"""Iteration-order-faithful simulation of GCC's ``__gnu_cxx::hash_map``.

glimmer-mg's classification mode iterates two ``hash_map<string, ...>``
tables (glimmer-mg.cc:361 over ICM paths, and Read_Meta_ICMs over the
``classifications`` map of read prefixes) and the iteration order of those
tables decides the record order of the ``.predict`` output file.  To be
byte-identical we reproduce the SGI/libstdc++ backwards hashtable exactly:

* string hash = ``__stl_hash_string``: ``h = 5*h + c`` over the bytes, in a
  64-bit unsigned long (backward_warning.h era, x86-64);
* bucket count starts at the first prime >= 100 (= 193) from the
  ``__stl_prime_list``; before each insert, ``resize(n_elements + 1)``
  grows to the first prime >= n_elements+1 when that exceeds the current
  bucket count;
* chains are head-inserted; a rehash walks old buckets 0..n-1 head-first
  and head-inserts into the new table;
* iteration yields buckets in ascending index, each chain head to tail.

Only the insert-only subset glimmer-mg uses is implemented.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

# __stl_prime_list (28 entries)
_PRIMES = (
    53, 97, 193, 389, 769, 1543, 3079, 6151, 12289, 24593,
    49157, 98317, 196613, 393241, 786433, 1572869, 3145739, 6291469,
    12582917, 25165843, 50331653, 100663319, 201326611, 402653189,
    805306457, 1610612741, 3221225473, 4294967291,
)


def stl_hash_string(s: str | bytes) -> int:
    """``__gnu_cxx::__stl_hash_string`` on a 64-bit unsigned long."""
    if isinstance(s, str):
        s = s.encode()
    h = 0
    for c in s:
        h = (5 * h + c) & _MASK64
    return h


def _next_size(n: int) -> int:
    for p in _PRIMES:
        if p >= n:
            return p
    return _PRIMES[-1]


class GnuHashMap:
    """Insert-only ``hash_map<string, V>`` with faithful iteration order."""

    def __init__(self) -> None:
        self._nbuck = _next_size(100)  # default-constructed hash_map
        self._buckets: list[list[str]] = [[] for _ in range(self._nbuck)]
        self._values: dict[str, object] = {}
        self._hash: dict[str, int] = {}  # memoized: rehashes reuse it

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __getitem__(self, key: str):
        return self._values[key]

    def __len__(self) -> int:
        return len(self._values)

    def insert(self, key: str, value=None):
        """``operator[]``: find-or-insert; returns the stored value."""
        if key in self._values:
            return self._values[key]
        self._resize(len(self._values) + 1)
        h = self._hash.get(key)
        if h is None:
            h = stl_hash_string(key)
            self._hash[key] = h
        self._buckets[h % self._nbuck].insert(0, key)
        self._values[key] = value
        return value

    def _resize(self, hint: int) -> None:
        if hint <= self._nbuck:
            return
        new_n = _next_size(hint)
        if new_n <= self._nbuck:
            return
        new_buckets: list[list[str]] = [[] for _ in range(new_n)]
        hashes = self._hash
        for chain in self._buckets:  # old buckets ascending
            for key in chain:  # head first, head-inserted into new chain
                new_buckets[hashes[key] % new_n].insert(0, key)
        self._buckets = new_buckets
        self._nbuck = new_n

    def keys(self):
        """Keys in hashtable iteration order."""
        for chain in self._buckets:
            yield from chain

    def items(self):
        for k in self.keys():
            yield k, self._values[k]


def gnu_hash_order(keys) -> list[str]:
    """Iteration order of a ``hash_map`` after inserting ``keys`` in order
    (duplicates keep their first position, as with ``operator[]``).

    Vectorized: the table's state only changes shape at the ~10 rehash
    points (bucket counts 193, 389, ...), and within an epoch the final
    chain layout is fully determined by (bucket, insertion position) — a
    chain iterates newest-first, so iteration order == lexsort by (bucket
    ascending, insertion position descending).  A rehash walks that
    iteration order and head-inserts into the new table, i.e. it is the
    same transform with the new bucket count; new keys append behind it.
    Equivalent to simulating ``GnuHashMap`` insert-by-insert (pinned by
    tests/test_util_tools.py), ~50x faster at 50k keys.
    """
    import numpy as np

    # first-occurrence dedup, preserving order
    seen = set()
    distinct = []
    for k in keys:
        if k not in seen:
            seen.add(k)
            distinct.append(k)
    m = len(distinct)
    if m == 0:
        return []

    # vectorized __stl_hash_string: h = 5h + c column by column
    enc = [k.encode() if isinstance(k, str) else k for k in distinct]
    lens = np.fromiter((len(e) for e in enc), dtype=np.int64, count=m)
    maxlen = int(lens.max()) if m else 0
    arr = np.zeros((m, maxlen), dtype=np.uint64)
    for i, e in enumerate(enc):
        arr[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    h = np.zeros(m, dtype=np.uint64)
    for c in range(maxlen):
        live = lens > c
        h[live] = h[live] * np.uint64(5) + arr[live, c]

    nbuck = _next_size(100)
    seq = np.empty(0, dtype=np.int64)  # insertion order into current table
    i = 0
    while True:
        j = min(m, nbuck)  # resize(count+1) fires when count+1 > nbuck
        seq = np.concatenate([seq, np.arange(i, j, dtype=np.int64)])
        i = j
        b = h[seq] % np.uint64(nbuck)
        order = np.lexsort((-np.arange(len(seq), dtype=np.int64), b))
        if i >= m:
            return [distinct[k] for k in seq[order]]
        seq = seq[order]  # rehash re-inserts in iteration order
        nbuck = _next_size(nbuck + 1)
