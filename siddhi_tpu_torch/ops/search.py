"""Stable partition, stable argsort and binary search (counterpart of
siddhi_tpu/ops/search.py).

`stable_partition_order` is kernel K1: on a CUDA tensor it launches
`csrc/k1_partition.cu`; on a CPU tensor it runs the plain version below.
`stable_radix_argsort` is kernel K7 (`csrc/k7_radix_sort.cu`), the stable
argsort of bounded or signed integer keys behind the session, sort,
keyed-session, expression and frequent windows, the time-first limiter,
ORDER BY and the table index, dispatched the same way;
`stable_argsort_bounded` runs on it on the card (K5's and K5b's slot sort,
the plain multimap append's bucket sort). `searchsorted32` is kernel K6
(`csrc/k6_search.cu`), the JAX function's binary walk, one launch a call on
a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def stable_partition_order_plain(live: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: two prefix sums and one scatter, as the JAX
    function computes it. int32 permutation with live lanes first."""
    n = live.shape[0]
    live_i = live.to(torch.int32)
    pos_live = torch.cumsum(live_i, 0, dtype=torch.int32) - 1
    n_live = live_i.sum(dtype=torch.int32)
    pos_dead = n_live + torch.cumsum(1 - live_i, 0, dtype=torch.int32) - 1
    dest = torch.where(live, pos_live, pos_dead).long()
    out = torch.empty(n, dtype=torch.int32, device=live.device)
    out[dest] = torch.arange(n, dtype=torch.int32, device=live.device)
    return out


_K1 = "k1_partition"


def stable_partition_order_cuda(live: torch.Tensor, *,
                                counter: str = "K1") -> torch.Tensor:
    """K1 on the card: one launch; above one tile of `k1_tile_lanes` lanes
    its look-back flags live in the library's workspace."""
    if live.dtype != torch.bool or live.dim() != 1:
        raise ValueError("stable_partition_order: live must be bool[L]")
    kernels.require_cuda("stable_partition_order", live)
    n = live.shape[0]
    dev = live.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    tiles = -(-n // kernels.bind(_K1, "k1_tile_lanes", [])())
    ws = (kernels.workspace(_K1, 4 * (2 + 2 * tiles), dev).data_ptr()
          if tiles > 1 else None)
    P = ctypes.c_void_p
    fn = kernels.bind(_K1, "k1_stable_partition_order",
                      [P, P, P, ctypes.c_int, P])
    rc = fn(live.data_ptr(), out.data_ptr(), ws, n, kernels.stream())
    kernels.check(_K1, "stable_partition_order", rc, dev)
    kernels.LAUNCHES[counter] += 1
    return out


def stable_partition_order(live: torch.Tensor, *,
                           counter: str = "K1") -> torch.Tensor:
    """Permutation that stably moves live lanes to the front (K1).
    `counter` names the launch counter of the calling site."""
    if live.is_cuda:
        return stable_partition_order_cuda(live, counter=counter)
    return stable_partition_order_plain(live)


def stable_argsort_bounded(x: torch.Tensor, bound=None, *,
                           counter: str = "K7 bounded") -> torch.Tensor:
    """Stable argsort of non-negative int32 keys, as int32 positions (the
    JAX function's). `bound`: the keys' static upper bound, where the
    caller knows one (K7's passes follow its bit length; None: 4 passes).
    On the card K7 (`counter` names the site), else the plain sort."""
    if x.is_cuda:
        return stable_radix_argsort(x, bound, counter=counter)
    return stable_radix_argsort_plain(x, bound)


_COUNT_TYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _walk_is_a_count(a: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the walk's compare is monotone over `a`: `a` nondecreasing,
    no NaN in `a` or `v`, one element type. Then the walk ends on the count
    of elements below `v` (at or below, side right), which
    torch.searchsorted gives in one call."""
    if a.dtype != v.dtype or a.dtype not in _COUNT_TYPES:
        return False
    if a.dtype.is_floating_point and bool(torch.isnan(a).any()
                                          | torch.isnan(v).any()):
        return False
    return bool((a[1:] >= a[:-1]).all())


def searchsorted32_plain(a: torch.Tensor, v: torch.Tensor,
                         side: str = "left") -> torch.Tensor:
    """Plain K6: the JAX function's walk over the bits of N, compare for
    compare (a NaN query lands at 0, where torch.searchsorted puts it at
    N). int32 positions shaped like `v`. Where the walk only counts
    (`_walk_is_a_count`), torch.searchsorted gives the same positions in
    one call."""
    if side not in ("left", "right"):
        raise ValueError(f"searchsorted32: side must be left or right, "
                         f"got {side!r}")
    if _walk_is_a_count(a, v):
        return torch.searchsorted(a.contiguous(), v.contiguous(),
                                  right=side == "right", out_int32=True)
    N = a.shape[0]
    pos = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for shift in range(N.bit_length() - 1, -1, -1):
        cand = pos + (1 << shift)
        probe = a[torch.clamp(cand - 1, 0, N - 1).long()]
        ok = probe < v if side == "left" else probe <= v
        pos = torch.where((cand <= N) & ok, cand, pos)
    return pos


_K6 = "k6_search"
#: element type -> the kernel's type code (bool as its bytes)
_K6_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
              torch.float64: 3, torch.bool: 4}


def searchsorted32_cuda(a: torch.Tensor, v: torch.Tensor,
                        side: str = "left", *,
                        counter: str = "K6") -> torch.Tensor:
    """K6 on the card: one launch (none for an empty `v`). `a` and `v` of
    two types meet in their promoted type, as the plain compares do."""
    if side not in ("left", "right"):
        raise ValueError(f"searchsorted32: side must be left or right, "
                         f"got {side!r}")
    if a.dim() != 1:
        raise ValueError("searchsorted32: a must be one-dimensional")
    if a.dtype != v.dtype:
        t = torch.promote_types(a.dtype, v.dtype)
        a, v = a.to(t), v.to(t)
    if a.dtype not in _K6_DTYPES:
        raise ValueError(f"searchsorted32: no kernel for {a.dtype}")
    a, vf = a.contiguous(), v.contiguous().reshape(-1)
    kernels.require_cuda("searchsorted32", a, vf)
    out = torch.empty(v.shape, dtype=torch.int32, device=a.device)
    if vf.numel() == 0:
        return out
    P = ctypes.c_void_p
    fn = kernels.bind(_K6, "k6_searchsorted",
                      [ctypes.c_int, ctypes.c_int, P, ctypes.c_int, P,
                       ctypes.c_longlong, P, P])
    rc = fn(_K6_DTYPES[a.dtype], int(side == "right"), a.data_ptr(),
            a.shape[0], vf.data_ptr(), vf.numel(), out.data_ptr(),
            kernels.stream())
    kernels.check(_K6, "searchsorted32", rc)
    kernels.LAUNCHES[counter] += 1
    return out


def searchsorted32(a: torch.Tensor, v: torch.Tensor,
                   side: str = "left") -> torch.Tensor:
    """Positions where `v` would insert into sorted `a`, as int32 (same
    sides as jnp.searchsorted, the JAX function's walk): K6 on the card,
    else the plain walk."""
    if a.is_cuda or v.is_cuda:
        return searchsorted32_cuda(a, v, side)
    return searchsorted32_plain(a, v, side)


# --------------------------------------------------------------------------- #
# K7: stable radix argsort
# --------------------------------------------------------------------------- #

#: int64 key of every NaN: above +inf, so NaNs sort last in lane order
_NAN_KEY = 2**63 - 1


def float64_sort_key(x: torch.Tensor, descending: bool = False):
    """int64 keys whose signed order is jnp.argsort's order of `x` as
    float64 (`-x` when descending, as SortWindow._rank_key negates): -0.0
    equals 0.0, and so does every subnormal (XLA compares with subnormals
    flushed to zero), every NaN (also -NaN) sorts last, -inf first. Ties
    stay ties, so a stable sort keeps their lane order."""
    k = x.to(torch.float64)
    if descending:
        k = -k
    nan = torch.isnan(k)
    tiny = torch.finfo(torch.float64).tiny
    k = torch.where(k.abs() < tiny, 0.0, k)  # -0.0 and subnormals -> 0.0
    bits = k.contiguous().view(torch.int64)
    # negative floats: larger magnitude, larger bits -> flip them
    key = torch.where(bits < 0, bits ^ (2**63 - 1), bits)
    return torch.where(nan, _NAN_KEY, key)


def stable_radix_argsort_plain(keys: torch.Tensor, bound=None,
                               width=None) -> torch.Tensor:
    """Plain K7: the JAX form, `jnp.argsort(keys, stable=True)[:width]`,
    as int32 lane ids. `bound` is the kernel's static key bound (unused
    here)."""
    order = torch.sort(keys, stable=True).indices.to(torch.int32)
    return order if width is None else order[:width]


_K7 = "k7_radix_sort"


def stable_radix_argsort_cuda(keys: torch.Tensor, bound=None, width=None,
                              *, counter: str):
    """K7 on the card, one launch. int32 keys in [0, bound] (a static
    bound; the pass count follows its bit length), int32 keys in signed
    order (bound None, 4 passes) or int64 keys in signed order (bound None,
    8 passes). Returns the first `width` lanes of the stable order, int32.
    Scratch is sized from the shapes alone: no host sync."""
    if keys.dim() != 1 or keys.dtype not in (torch.int32, torch.int64):
        raise ValueError("stable_radix_argsort: keys must be int32[L] or "
                         "int64[L]")
    if keys.dtype == torch.int64 and bound is not None:
        raise ValueError("stable_radix_argsort: int64 keys take no bound")
    if bound is not None and not 0 <= bound < 2**31:
        raise ValueError("stable_radix_argsort: bound must be in [0, 2^31)")
    kernels.require_cuda("stable_radix_argsort", keys)
    n = keys.shape[0]
    width = n if width is None else width
    if not 0 <= width <= n:
        raise ValueError("stable_radix_argsort: width must be in [0, L]")
    dev = keys.device
    out = torch.empty(width, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    radix = kernels.bind(_K7, "k7_radix_bits", [])()
    bits = (max(int(bound).bit_length(), 1) if bound is not None
            else 8 * keys.element_size())
    passes = -(-bits // radix)
    if n > kernels.bind(_K7, "k7_small_max", [])():
        # ping-pong keys and ids, the histogram, a look-back region a pass
        tiles = -(-n // kernels.bind(_K7, "k7_tile_keys", [])())
        nbytes = (-(-2 * n * keys.element_size() // 8) * 8 + 8 * n
                  + 4 * (8 << radix) + 4 * passes * tiles * (1 << radix))
    else:  # one block, all in shared memory
        nbytes = 1
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ws = kernels.workspace(
        _K7, kernels.bind(_K7, "k7_workspace_bytes", [])(), dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    tail = (out.data_ptr(), scratch.data_ptr(), ws.data_ptr(),
            kernels.stream())
    if bound is not None:
        fn = kernels.bind(_K7, "k7_argsort_u32", [P, I, I, I, P, P, P, P])
        rc = fn(keys.data_ptr(), n, bits, width, *tail)
    else:
        entry = "k7_argsort_i64" if bits == 64 else "k7_argsort_i32"
        fn = kernels.bind(_K7, entry, [P, I, I, P, P, P, P])
        rc = fn(keys.data_ptr(), n, width, *tail)
    kernels.check(_K7, "stable_radix_argsort", rc, dev)
    kernels.LAUNCHES[counter] += 1  # one launch a sort, every pass in it
    return out


def stable_radix_argsort(keys: torch.Tensor, bound=None, width=None, *,
                         counter: str) -> torch.Tensor:
    """Stable argsort of bounded integer keys, first `width` lanes, int32
    (K7). `counter` names the launch counter of the calling site."""
    if keys.is_cuda:
        return stable_radix_argsort_cuda(keys.contiguous(), bound, width,
                                         counter=counter)
    return stable_radix_argsort_plain(keys, bound, width)
