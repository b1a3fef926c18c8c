# Frozen copy of glimmer_mg_torch/utils/stdsort.py at commit ab5a5d3.
"""Faithful reimplementation of libstdc++ std::sort (introsort).

The reference sorts event lists and start lists with std::sort, which is
UNSTABLE: elements with equal keys end up in an algorithm-determined order
(median-of-three quicksort to depth 2*log2(n), insertion sort below 16
elements, heapsort fallback). Equal-key ordering decides genuine ties in
the prediction engine (e.g., equal-score start candidates from different
indel branches — Start_Cmp at glimmer-mg.cc:1660, Event_Pos_Cmp at
glimmer_base.cc:1567), so bit-parity requires reproducing the exact
permutation, not just a sorted order.

Mirrors libstdc++ bits/stl_algo.h (GCC 12): __introsort_loop,
__unguarded_partition_pivot, __move_median_to_first, __final_insertion_sort,
and the heap variants from bits/stl_heap.h.
"""

from __future__ import annotations

_S_THRESHOLD = 16


def std_sort(a: list, less) -> None:
    """In-place std::sort(a.begin(), a.end(), less)."""
    n = len(a)
    if n <= 1:
        return
    depth_limit = 2 * (n.bit_length() - 1)  # 2 * floor(log2(n))
    _introsort_loop(a, 0, n, depth_limit, less)
    _final_insertion_sort(a, 0, n, less)


def _introsort_loop(a, first, last, depth_limit, less):
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            _heap_sort(a, first, last, less)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, less)
        _introsort_loop(a, cut, last, depth_limit, less)
        last = cut


def _move_median_to_first(a, result, x, y, z, less):
    if less(a[x], a[y]):
        if less(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif less(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif less(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif less(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, less):
    while True:
        while less(a[first], a[pivot]):
            first += 1
        last -= 1
        while less(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, less):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, less)
    return _unguarded_partition(a, first + 1, last, first, less)


def _unguarded_linear_insert(a, last, less):
    val = a[last]
    nxt = last - 1
    while less(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


def _insertion_sort(a, first, last, less):
    if first == last:
        return
    for i in range(first + 1, last):
        if less(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, less)


def _final_insertion_sort(a, first, last, less):
    if last - first > _S_THRESHOLD:
        _insertion_sort(a, first, first + _S_THRESHOLD, less)
        for i in range(first + _S_THRESHOLD, last):
            _unguarded_linear_insert(a, i, less)
    else:
        _insertion_sort(a, first, last, less)


# ---- heapsort fallback (bits/stl_heap.h) ----


def _push_heap(a, first, hole, top, value, less):
    parent = (hole - 1) // 2
    while hole > top and less(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, less):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length % 2 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, less)


def _make_heap(a, first, last, less):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, less)
        if parent == 0:
            return
        parent -= 1


def _heap_sort(a, first, last, less):
    _make_heap(a, first, last, less)
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, less)
