#!/usr/bin/env python3
"""Drive siddhi_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit; build every kernel under
   siddhi_tpu_torch/csrc/ with `nvcc -Xptxas -v` and print the report;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (K1, K3 and K4 bit for bit, K4 including the
   table state; K5 within rtol 1e-5), with its time (CUDA events), the
   plain version's time, a single PyTorch library call where one computes
   the same function, and the least time the card could take (bytes over
   3.35 TB/s, counted from this run's inputs); K1 also at its edges (n
   = 1, 31, its one-block limit and one each side, 393,216 and 2^20 + 1,
   every lane live or dead, flags at an odd address, small calls right
   after the largest), bit for bit, one launch a call;
3. app A, BASELINE config 2 as written: lengthBatch(10000) sum/avg grouped
   by a string symbol over 1,000,000 symbols, group_capacity 2^20,
   batch_size 131072, 8 rounds of send_columns + flush (1,048,576 events);
4. app B: the same query keyed by a long account id behind a filter;
5. both apps' outputs against an independent numpy oracle (strings, longs
   and timestamps exact, floats rtol 1e-5), and each on-path kernel's
   launch counter non-zero; then the query step alone over the same
   rounds (device batches prepared beforehand) and the places where one
   step syncs with the host;
6. the sliding-window kernels: each K2b entry point of the packed ring
   (pack-compact, fetch, append across the ring's end, gather; the gather
   timed on a random order and on app D's merge order), each K5b
   scan (grouped sum/min/max and ungrouped with and without resets, int64
   and float32) and the K5 scan without GROUP BY (three components)
   against its plain version at the sliding apps' shapes (B = E = C =
   131072, W = 6 words; L = 262144 lanes, K = 2^20): K2b, integer scans
   and min/max bit for bit, float32 sums within rtol 1e-5 of the largest
   running value; with the same timings; and the torch routes K2a, K6 and
   the K7 merge timed at their shapes;
7. app C, BASELINE config 3 (time(60 sec) distinctCount(symbol) over
   100,000 symbols, in playback), app D (length(100000) sum/count grouped
   by 1,000,000 symbols), app E (time(60 sec) distinctCount(volume)
   grouped by 1,000 symbols) and app F (length(100000) sum/sum/count
   without GROUP BY), 1,048,576 events each, every output event against
   an independent numpy oracle (counts and long sums exact, float sums
   rtol 1e-5 plus atol 1e-3 for the float32 residues of removal), with
   the same per-app numbers as apps A and B;
8. the join kernels against their plain versions at app G's shapes, bit
   for bit: K3b (one int key column of B = 8192 lanes, with and without
   the validity mask), K10 append (the whole multimap state after a
   sequence of batches that wraps a C = 100000 ring more than twice, H =
   2^18 buckets), K10 probe (k_max = 16; once more on a state whose
   arrival tags cross 2^32, so the u32 ages wrap), as the step runs it
   (probe and compaction in one launch: lanes, rows, pv, the pairs past
   pair_cap and the truncated lanes against multimap_probe_plain and
   compact_pairs_plain) and alone, and K10 compact (P = 131072 candidates
   into pair_cap = 32768, at app G's density and with more valid lanes
   than pair_cap); with the same timings; then (its own generator) K10
   append's edges and the fused probe's (pair_cap overflow, every lane
   invalid, one hot key past k_max, tags across 2^32, k_max = 1, B = 1,
   a partial tile), one launch a call, the workspace left zero;
9. app G, BASELINE config 5 as bench.py writes it: a stream-stream equi
   join over two length(100000) windows, 64 rounds of 8192 events on each
   side (1,048,576 events), keys uniform over 1..100000; every output
   event against an independent numpy oracle (keys, timestamps and the
   stored float32 values exact), no dropped pair, the same per-app
   numbers, every probe step one fused probe launch; the same app once
   more at a pair cap factor of 16 (no step compacts: the probe alone,
   its [B, k_max] block as is) against the same oracle; and the two join
   probes that are compositions (the sort-merge
   `probe_equi` and `probe_cross`) timed at app G's probe batch;
10. the pattern kernels against their plain versions at app I's shapes
   (B = 32768 arrivals, a P = 131072-slot pending table 45% full in
   scattered slots), bit for bit: K11a first_match in pattern and in
   sequence mode, each with and without a residual mask, K7 on the
   batch's equality column as K11a's index sorts it, and K11b
   pending_insert (the whole table and the drop count), once into free
   slots and once overflowing them; with the same timings; then (its own
   generator) K11b's edges (no free slot, more candidates than free
   slots, W = 0, P not a multiple of the block, more than 32 column jobs,
   an empty table, one block), ceil(jobs / 32) launches a call, tables of
   three sizes alternating on one stream with the workspace left zero;
11. app H, BASELINE config 4 as bench.py writes it (`every a=StreamA ->
   b=StreamB[b.val == a.val] within 5 sec`, batch_size 32768, pending
   capacity 131072, @app:playback), and app I, the same query on uniform
   values where `within` and the first match decide: 16 rounds of one A
   and one B batch (1,048,576 events) each, every output event in order
   against a numpy oracle that models the pending table's slots, no
   dropped partial match, the same per-app numbers;
12. the aggregator kernels against their plain versions at apps J-L's
   shapes (C = 131072 ring rows, L = 262144 chunk lanes): K8 bit for bit
   (float32 max over a wrapped ring, int64 min over a chunk with no
   CURRENT lane, float32 max with NaN), grouped K8 bit for bit (1,000 and
   1,000,000 groups), K9 HLL ungrouped and grouped (G = 4096, slots past
   G) with 0, 1 and 3 RESETs: registers and the drop count bit for bit,
   estimates within max(1, 1e-5 E); K5b's int32 min/max; with the same
   timings;
13. apps J (BASELINE config 3 in its HLL form: time(60 sec)
   hll:distinctCount(symbol) over 100,000 symbols), K (time(60 sec)
   max/min grouped by 1,000 symbols), L (length(100000) max, min and
   maxForever) and M (timeBatch(1 sec) max/min/avg/stdDev/count grouped
   by 100 symbols), 8 rounds of 131072 events each, every output event
   against an independent numpy oracle (J: a model of the sketch, within
   max(1, 1e-5 E), and 3 standard errors of the exact distinct count;
   extrema and counts exact; M's avg rtol 1e-5 and stdDev within 1e-4 sd
   + sqrt(4 eps32 mean^2)), each new kernel launched, 0 host syncs a step,
   the same per-app numbers;
14. the wire pack K12a against its plain version on the card, the header
   and every region's valid entries bit for bit, at B = 131072 lanes for three output schemas (apps A, G and N) with no,
   every and half the lanes valid, EXPIRED and RESET lanes, and a 2^32 ms
   span; then (its own generator) one launch a call at B = 0, 1, 256,
   1,025, 131,072 and 2^20, every lane invalid, an `over` batch, a span
   of 2^32 - 1 and strided columns, the sizes alternating on one stream;
   with its timings, and the copy of the packed buffer into pinned
   memory against the per-column readback it replaces;
15. app N, BASELINE config 1 as bench.py writes it (`from
   TradeStream[700.0 > price] select symbol, price`, 1,000 symbols, price
   uniform on [0, 1000)), 8 rounds of 131072, every row against a numpy
   oracle;
16. the absent and every-group kernels against their plain versions at
   app I's shapes (B = 32768 arrivals, P = 131072 entries), bit for bit:
   K11c absent_scan with and without the equality pair and the residual
   tile, with deadlines on both sides of the batch's timestamps and
   without a timer; K11d match_count with and without the pair and the
   residual; K11e release_origin with W = P completions, several per
   origin and some without one (-1); with the same timings;
17. app O (`every a=StreamA -> not StreamB[val == a.val] for 5 sec`,
   @app:playback) and app P (`every a=StreamA -> every
   b=StreamB[b.val == a.val] within 5 sec`) on app I's feed, a closing
   heartbeat past O's last deadline, every event in order against numpy
   oracles of the pending table (O: each A no equal value reaches inside
   5 sec fires at its deadline, 0 dropped; P: every equal-valued B within
   5 sec, at most pattern_sticky_passes an A a batch, pass-major, and the
   rest counted in `dropped` and Statistics.overflow); app Q (`every
   a=StreamA, b=StreamB[b.val == a.val]`, a sequence across two streams
   on the merged junction), 8 rounds of 16384 rows in a random interleave
   sent as runs of one stream by send_columns, against the adjacent
   (A, B) pairs of equal value in send order; apps R (the mid and head
   every-group shapes of tests/test_absent_patterns.py, 8 rounds of 256
   S1 and 64 S2 events) on the card against the CPU, event for event;
   each app's kernels launched and 0 host syncs a step;
18. K7, the stable radix argsort, against its plain version on the card,
   bit for bit, at each site's shape: app S's session chunk (L = 3B =
   393,216 emission keys, ~40% invalid), app V's sort chunk (L = 2B + N
   = 272,144), app V's rank passes over M = N + B = 141,072 float64 keys
   with ties, -0.0, NaN and ±inf (asc and desc; and the whole two-key
   `_rank_key` on the card against the CPU), app T's key grouping (B
   keys below K = 4096, invalid lanes at K) and app T's top-E (the
   oldest E = B of C = 262,144 ring ages); with the same timings, the
   library call being `torch.sort(stable=True)`;
19. apps S (`session(5 sec)`: bursts of 1,000-50,000 events 1 ms apart
   between idle jumps of 6-20 s, a heartbeat after each round), T
   (`session(5 sec, symbol)`: 1,000 symbols taking turns in four groups
   of 250 over 20 s phases), U (app D's query through a named
   `length(100000)` window) and V (`sort(10000, price, 'desc', volume)`,
   a top-10,000 leaderboard), `insert all events` but U, 8 rounds of
   131072 each under @app:playback, every event in order against numpy
   oracles (S: each session's rows expired before the next session's
   first current; T: a model of the per-key sessions, at most E closed
   rows a step, oldest first; U: oracle_d; V: np.lexsort on (-price,
   volume, merge position)), strings, longs, timestamps and stored
   float32 values exact, U's sums rtol 1e-5; T drops no key; each app's
   K7 counters non-zero and 0 host syncs a step;
20. K7 on the expression windows' packed chunks (app W's L = E + B =
   262,144 and app X's batch chunk L = 2P + B = 655,360 lanes, and the
   whole `_sort_chunk_packed` against the CPU), K13a's sliding walk and
   batch scan at app X's shapes (B = 131072, a 5,000,000 volume budget at
   its steady state, and a 10,000.0 price budget), K13a on seven more
   conditions (first/last/current attributes, avg, stdDev,
   eventTimestamp, `%` with negative operands, windows that empty, in
   both modes), K13b at app Y's N = 64 and 10,000 slots, and app Y's
   int64 key and slot-key sorts, each against its plain version on the
   card, bit for bit, with the same timings (the library calls:
   `torch.sort(stable=True)`, and `scatter_reduce_(amax)` plus a gather
   for K13b; K13a has none);
21. apps W (`expression('count() <= 100000')`), X
   (`expression('sum(volume) <= 5000000')` with volumes 1-100, and
   `expressionBatch('sum(price) < 10000.0', true)` with prices on a 1/64
   grid), Y (`frequent(64, symbol)`, `frequent(9600, symbol)` and
   `lossyFrequent(0.001, 0.0001, symbol)` over 10,000 symbols drawn
   Zipf(1.2): a batch holds about 9,400 of them, so frequent(64) drains
   every counter and emits nothing, while frequent(9600) tracks them and
   evicts at the decrements) and Z
   (`#pol2Cart(price, volume)#window.hopping(10 sec, 1 sec)[x > 0.0]`
   grouped by symbol, and `#window.cron('*/1 * * * * ?')`, 20 events a
   ms), `insert all events` but Z's hopping query, 8 rounds of 131072
   each under @app:playback, every event in order against numpy oracles
   (W: length(100000), each arrival's CURRENT then the row it pops; X:
   the frontiers of the prefix sums, at most E pops a step, and the
   greedy segmentation of the price sums; Y: the batched Misra-Gries and
   lossy counters on K3's hash; Z: the ring's rows of the last hop in
   slot order with per-symbol running sums, and each round's rows with
   the previous round's expired), strings, longs, timestamps and doubles
   exact, Z's sums rtol 1e-5; each app's kernels launched and 0 host
   syncs a step for every query;
22. K13c, the rate limiters' ring, against its plain version on the
   card, bit for bit: the append of B = 131072 lanes (ts, three columns,
   valid and type) into a C = 262144 ring across its end and the gather
   of C lanes from a wrapped start (`output all every 1 sec`), the
   snapshot ring's append of a 262,144-lane sliding chunk into Cap =
   262144 and its gather of a 4,096-row window; and the new sites of the
   ported kernels at apps AA and AB's shapes: K7 on time-first bucket
   keys and on float64 ORDER BY keys, K1's valid-first partition, K5b's
   int32 LIMIT rank and int64 event ordinal, K13b's last lane per group
   slot (G = 1024); with the same timings (the library calls: `ring[:,
   slot] = rows` and `index_select` on the ring's word matrix with the
   slots given, `torch.sort(stable=True)`, `torch.cumsum`,
   `scatter_reduce_(amax)` plus gathers);
23. apps AA (a dashboard's rates over 1,000 symbols at 20 events a ms:
   `output last every 100 events`, `output all every 1 sec`, `output
   first every 1 sec`, a grouped `time(5 sec)` avg/count `output
   snapshot every 1 sec` and a `length(4096)` `output snapshot every 1
   sec`) and AB (a leaderboard on app A's feed: `lengthBatch(10000)`
   sum(volume)/avg(price) by symbol `order by total desc, ap limit 10
   offset 2`), 8 rounds of 131072 each, every event in order against
   numpy oracles (the ordinals, the buckets, each symbol's windowed mean
   and count at its last arrival before a tick, the window as of the
   tick's boundary, each step's stable sort of its flushes' running
   values), strings, longs, timestamps and stored float32 values exact,
   means rtol 1e-5 plus atol 1e-3; each app's kernels launched and 0
   host syncs a step for every query;
24. the table kernels against their plain versions on the card, bit for
   bit: K13d's primary-key dedup of B = 16,384 lanes of string codes
   (in-batch repeats) against C = 65,536 rows, 40,000 live, and its
   placement of the staying lanes into the free rows (the table state
   and both counts; once more overflowing, which must write nothing);
   K13e's per-row any, last matching event and per-event any: the mask
   route over an [8,192 x 65,536] condition (app AD's shape) with both
   valid vectors and over a table-only [C] condition, the equality route
   at app AD's shape (8,192 ids against 65,536 rows, the [B, C] mask path
   it replaces timed beside it; their inputs from their own generator);
   and the new sites of the
   ported kernels: K1 on the table's free rows, K7 on its index keys,
   K13b's last lane per group of an on-demand aggregate; with the same
   timings (the library calls: the [B, C] and [B, B] equality masks with
   `any` for the dedup, `index_put_` of the rows with the slots given
   for the placement, `any` / `argmax` over the flipped mask / `any` for
   K13e, `torch.sort`, `scatter_reduce_(amax)`); then (its own generator)
   K13d's edges, bit for bit, one launch a call: the dedup on NaN, ±0.0
   and ±inf in float32 and float64 keys, alone and beside an integer
   column, swapped int64 pairs, bool beside int64, int64 keys differing
   only above bit 32, every lane one key (live in the table and not),
   repeats behind invalid lanes, B = 0, C = 0, B = 1 and 2,048 lanes
   against 2^20 rows, the sizes alternating on one stream; the placement
   of 1 lane, of none, of lanes that fit the free rows exactly, of one
   lane too many (nothing written) and of 131,072 lanes into 2^18 rows;
   the dedup timed at app AD's shape (8,192 unmatched ids against
   50,000 live rows); and K13e's two routes, one launch a call, the
   routes and sizes alternating on one stream: the equality route on NaN,
   ±0.0 and ±inf in float32 and float64 keys, int64 keys differing only
   above bit 32, string codes, two- and four-column keys, bool beside
   int32, repeated keys, invalid lanes, dead rows, B = 1, no live row, no
   valid lane, every row one key and AD's shape; the mask route on [B, C]
   conditions (sparse, dense, C = 1,000, a transposed view, a view one
   column in), [B, 1], [C], a host and a card scalar, no lane valid
   vector, every lane invalid, no live row, B = 1 and C = 1;
25. apps AC (reference-data enrichment: 50,000 symbols fed into an
   @PrimaryKey / @Index table in 4 batches of 16,384 lanes, 15,536 of
   them repeats, then 8 rounds of 131,072 trades over 60,000 symbols
   filtered by `in SymbolTable` and joined with the table, then two
   on-demand finds) and AD (an account ledger: 8 rounds of 8 `update or
   insert` batches of 8,192 transactions over 60,000 ids and a 1,024-id
   `delete` batch into C = 65,536 rows, after each round an on-demand
   grouped sum and an on-demand delete), every event, table row and
   found row against independent numpy oracles of the JAX semantics
   (first primary key wins, the last matching event updates a row with
   SET against the row as it was, two new events of one key insert
   once), strings, longs and stored float32 values exact, on-demand sums
   within 1e-5 of the sum of magnitudes; each app's kernels launched;
   one host read a table insert (its overflow and dropped counts) and
   none elsewhere in a step; one launch each of the dedup, K1 on the free
   rows and the placement an insert; AD's `on Account.id == id` one
   launch of K13e's equality route a step (none of the mask route), and
   the peak device memory of its update-or-insert steps;
26. K13f, the aggregation's bucket scatter, against its plain version on
   the card: app AE's ten columns (the bucket and symbol set, the alive
   flags, float32 sums, min and max with NaN and ±inf, int64 sums) in one
   launch of B = 131,072 lanes into K = 2^20 slots at low contention
   (~125,000 slots, AE's `sec` store) and high (10,000 slots, its hour to
   year stores), set, min, max and int64 sums bit for bit, float32 sums
   within 1e-5 of the slot's sum of magnitudes; the evict (a 2^20-slot
   store's kept rows into a fresh one) and AF's restore (90,000 rows),
   bit for bit; and the aggregation sites of K3 and K4; K13f, its plain
   version and the library calls (`index_put_`, `index_add_` and
   `scatter_reduce_` with the slots given) timed on the device alone,
   back to back behind a spin kernel with L2 flushed before each, and
   one K13f call with its host enqueue beside it; K13f's bound counts
   the kept lanes' distinct sources, every lane's slot, and the touched
   slots' set columns written and reduced columns read and written;
27. apps AE (rollups for a trading dashboard: `every sec ... year` over
   10,000 symbols with sum, avg, min, max, count and sum(volume), `@purge`
   of `sec` buckets after 5 min, 8 rounds of 131,072 trades 1 ms apart
   from 2025-12-31 23:50:00 UTC, so the run crosses a minute, hour, day,
   month and year; each round a heartbeat, a grouped find over the last
   5 minutes of `sec` buckets, finds per `min`, `month` and `year`, and
   4,096 query events joined `per 'hour'`) and AF (a durable `@store`
   aggregation per `min`, `hour`, `day` fed AE's first 4 rounds, shut
   down, rebuilt in a fresh runtime, fed the rest), every found, joined
   and rebuilt row against numpy oracles (buckets by `ts - ts % w` and
   datetime64, float64 sums by `np.add.at`), counts, volumes, min, max
   and buckets exact, sums within 1e-5 of the sum of magnitudes; the
   `sec` store holding only buckets at or after now - 5 min; no dropped
   join pair; 0 host syncs in an ingest step;
28. K12b, the superstep pack, against its plain version on the card, bit
   for bit (the header, the K counts and every region's kept entries), at
   app AG's emitting slot (W = 141,087 lanes of int32 code, two float32
   and the int64 ts) for K = 8 and 32 with one iteration empty and one
   full; timed on the device alone beside the library calls
   (`nonzero_static` of the flat valid at the kept count, so that no call
   syncs with the host, an `index_select` a column, `valid.sum(1)`); the
   bound counts ts and column reads only in sectors with a valid lane;
29. app AG, bench.py's IngressBench (`@Async(buffer.size='131072',
   workers='4')`, `TradeStream[price < 700.0]` into a `lengthBatch(10000)`
   sum/avg by 10,000 symbols, group_capacity 2^17, async_callbacks and a
   columnar callback): (a) one producer sends 64 chunks by send_columns
   on fresh runtimes at K = 1, 8 and 32; K = 1 against app A's oracle,
   K > 1 bit-identical to K = 1 with 64 / K supersteps, no decline and
   one K12b launch a superstep; (b) four producers push the same 96
   chunks with one drain, three rounds over K = 1, 8, 32 in turn:
   events/s of each run (the median and the spread), p50/p99
   send-to-callback latency, the pipeline's stage times, conservation
   (sent, submitted and delivered rows; output rows from the passing
   count) and the host syncs of one superstep (at most its one
   readback);
30. app AH, config 1's auto-flush path: `TradeStream[700.0 > price]` with
   auto_flush_ms=10 and batch_size 256, 2,000 rows sent one at a time at
   1,000 a second with no flush(); every passing row arrives, in order,
   exact; p50/p99 send-to-callback latency;
31. (run right after phase 2) K5/K5b and K7 at their edge shapes against
   their plain versions: n of 1, a tile - 1, a tile, a tile + 1 and 3
   tiles + 5 (and K7's one-block limit and one past it); K5/K5b with
   resets on tile edges, one segment across every tile, dead epochs, sum,
   min and max over float32, float64, int64 and int32 (integers, min and
   max bit for bit, float sums within rtol 1e-5 of the largest running
   value), the running count; float32 and float64 sums run twice at L =
   262,144 (K = 2^20 grouped, and ungrouped) with equal bits; K7 on
   unsigned-bounded, signed int32 and int64 keys with their extremes,
   keys constant in some digits, all keys equal (every pass skipped), the
   whole order and width < n, and more tiles than the cooperative grid
   holds at once, bit for bit; one launch a K5b component, a K5 plan of
   up to four sum components and a K7 sort;
32. (run right after phase 31) K11a and K13a at their edges against their
   plain versions, bit for bit: first_match with no equality and with one
   to four columns of bool, int32 and int64 (negative and extreme
   values), runs far longer than a warp, every entry matching and none,
   `within` failing on a lane with a later lane passing (unsorted ts),
   timestamps near the int64 extremes, residual tiles, dead entries and a
   live mask, sequence mode, P = 0, B = 1 and no valid lane, with K11a's
   launches (the index, then one a residual tile); both K13a walks on
   conditions true and false on every check, the E cap, the 2B + E + 8
   cap (E below -2B), NaN means of empty windows, pop chains past a band,
   frontiers moving 0, 1 and several rows an arrival, expressionBatch
   flushes on an empty window with the trigger in and out and n_valid
   inside a tile, at sizes around the tiles, one launch a call;
33. (run right after phase 32) K11c and K11d at their edges against their
   plain versions, bit for bit: absent_scan with deadlines on both sides
   of each run and untimed, match_count with and without `within`, on
   batches with no equality and one to four columns of bool, int32 and
   int64, long runs (past a warp's walk) with unsorted ts, `within`
   failing mid-run then passing, every entry matching and none, ts -
   start_ts wrapping int64, residual tiles with p0 > 0, dead entries, P =
   0, B = 1 and no valid lane; each with its own index (one probe a
   residual tile, the gather, K7 an equality column) and again on an
   index built beforehand (the probes alone);
34. (run after phase 30, its own generator) K4b, the dense key table of a
   partition's key-slot path, against its plain version bit for bit (ids,
   sorted_keys, sorted_ids, count), one launch a call: app AJ's first
   batch and steady state (L = 8,192 lanes, K = 1,024, 1,000 keys),
   131,072 lanes into K = 64 and K = 4,096 (more new keys than K), L = 1,
   no valid lane, every key new, every key found, keys equal to INT64_MAX
   and INT64_MIN, heavy repeats, count + n_new > K, a full table
   receiving smaller keys (eviction) and 8,192 new keys into K = 1,024,
   the sizes alternating on one stream; K4b timed at three of them, and
   K3 on app AJ's key column ("K3 partition");
35. apps AI and AJ: `partition with (symbol of TradeStream)` around
   `[700.0 > price]#window.length(100)` sum, avg and count, 1,000
   symbols, 8 rounds of 8,192 trades 1 ms apart and a heartbeat; AI on
   the per-key host loop, AJ on the key-slot path (`mesh=[card]`,
   partition_capacity 1,024); each against a numpy oracle of per-symbol
   `length(100)` sums, means and counts (strings, counts and timestamps
   exact, sums rtol 1e-5; AI ordered by key code within a batch, AJ by
   slot), the two equal as per-key sequences, K4b and "K3 partition" one
   launch a batch on AJ and none on AI, the route's host reads and
   deliveries of one batch (AJ: the count read and one delivery; AI: the
   valid and key reads and one delivery a key present), events/s, ms a
   round and peak device memory.

Every app's Event callback reads back through K12a (its launch counter
must be non-zero in every app). Apps A, C, D, G, H and N also run the
path bench.py measures, on the same input as their Event run:
`async_callbacks=True`, a ColumnarBlock callback, send_columns + flush,
drain; every block's rows against the same oracle, 0 host syncs at the
decoder hand-off (torch.cuda.set_sync_debug_mode('warn') around the pack,
the copy and the submit), events/s of both callback forms, the
send-to-callback latency of each block (p50, p99), a split of the round
into ingest, step, pack + copy, unpack and Event or block build (a
synchronous run with the card synchronised at each stage boundary), and
the peak device memory; they are printed as one JSON line
{"columnar": ...}. The host encoder that ran (native or Python) is
printed; the run fails unless the native one ran. Apps A and N run their
Event path once more with the Python host encoder in place of the native
one, against the same oracle, so the two encoders' rates come from one
call.

The second-to-last lines are the kernel table as one JSON object and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one card; without one, or without the package beside it, it
exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import threading
import time
import traceback
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
BATCH = 131072
ROUNDS = 8
N_KEYS = 1_000_000
GROUP_CAP = 1 << 20
WINDOW = 10_000
RTOL = 1e-5  # float32 sums vs the float64 oracle (numeric-parity policy)

APP_A = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.lengthBatch(10000)
select symbol, sum(price) as total, avg(price) as avgPrice
group by symbol
insert into SummaryStream;
"""

APP_B = """
define stream TradeStream (account long, price double, volume long);
@info(name = 'bench')
from TradeStream[price > 20.0]#window.lengthBatch(10000)
select account, sum(price) as total, avg(price) as avgPrice
group by account
insert into SummaryStream;
"""

# BASELINE config 3 as bench.py writes it, with @app:playback so that the
# window follows event time (wall-clock `now` would expire every event at
# the end of its own batch)
APP_C = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.time(60 sec)
select distinctCount(symbol) as distinctSymbols
insert into OutStream;
"""

# the north star: a sliding group-by; EXPIRED lanes feed K5 negative deltas
APP_D = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.length(100000)
select symbol, sum(price) as total, count() as n
group by symbol
insert into OutStream;
"""

# exact grouped distinctCount on the (symbol, volume) pair table
APP_E = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.time(60 sec)
select symbol, distinctCount(volume) as n
group by symbol
insert into OutStream;
"""

# a sliding sum without GROUP BY: the ungrouped K5 scan, EXPIRED lanes
# negative
APP_F = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.length(100000)
select sum(price) as total, sum(volume) as vol, count() as n
insert into OutStream;
"""

# BASELINE config 5 as bench.py writes it (bench_join)
APP_G = """
define stream LeftStream (k int, v double);
define stream RightStream (k int, v double);
@info(name = 'bench')
from LeftStream#window.length(100000) as a
join RightStream#window.length(100000) as b
on a.k == b.k
select a.k as k, a.v as lv, b.v as rv
insert into OutStream;
"""
BATCH_G = 8192  # bench.py's join batch
ROUNDS_G = 64
LENGTH_G = 100_000
K_MAX = 16
BUCKETS_G = 1 << 18  # multimap_buckets(100000)
PAIR_CAP_G = 32768  # min(B * k_max, max(4 * B, 32768))

# BASELINE config 4 as bench.py writes it (bench_pattern), with
# @app:playback so that `within` follows event time
APP_H = """
@app:playback
define stream StreamA (val int);
define stream StreamB (val int);
@info(name = 'bench')
from every a=StreamA -> b=StreamB[b.val == a.val] within 5 sec
select a.val as aVal, b.val as bVal
insert into OutStream;
"""
BATCH_P = 32768  # bench.py's accelerator e2e batch for config 4
ROUNDS_P = 16
PENDING_P = 4 * BATCH_P
WITHIN_P = 5000
#: app I's values are uniform over 1..VALUES_I at BATCH_P lanes (scaled
#: with the batch, so a smaller run keeps the match rate)
VALUES_I = 100_000

# the aggregator apps (phase 13); {} takes the window parameter
APP_J = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.time({})
select hll:distinctCount(symbol) as distinctSymbols
insert into OutStream;
"""
APP_K = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.time({})
select symbol, max(price) as high, min(price) as low
group by symbol
insert into OutStream;
"""
APP_L = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.length({})
select max(price) as hi, min(volume) as lo, maxForever(price) as top
insert into OutStream;
"""
APP_M = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.timeBatch({})
select symbol, max(price) as high, min(price) as low, avg(price) as avgPrice,
       stdDev(price) as sd, count() as n
group by symbol
insert into OutStream;
"""
M_SYMBOLS = 100
HLL_M = 1024  # registers per group (config.hll_registers)

# BASELINE config 1 as bench.py writes it (bench_filter)
APP_N = """
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream[700.0 > price]
select symbol, price
insert into OutStream;
"""
N_SYMBOLS = 1_000
N_PRICE_HI = 1000.0

TIME_WINDOW_MS = 60_000
LENGTH_D = 100_000
C_SYMBOLS = 100_000
E_SYMBOLS = 1_000
ATOL_SLIDING = 1e-3  # float32 residues of removal in sliding sums

WINDOWS = "siddhi_tpu/ops/windows.py"
GROUPBY = "siddhi_tpu/ops/groupby.py"
K5_SRC = "siddhi_tpu_torch/csrc/k5_grouped_scan.cu"
K2B_SRC = "siddhi_tpu_torch/csrc/k2b_packed_ring.cu"
K10_SRC = "siddhi_tpu_torch/csrc/k10_join.cu"
JOIN = "siddhi_tpu/ops/join.py"
K11_SRC = "siddhi_tpu_torch/csrc/k11_pattern.cu"
K11C_SRC = "siddhi_tpu_torch/csrc/k11c_absent.cu"
PATTERN = "siddhi_tpu/core/pattern_runtime.py"
K8_SRC = "siddhi_tpu_torch/csrc/k8_extrema.cu"
K9_SRC = "siddhi_tpu_torch/csrc/k9_hll.cu"
AGGS = "siddhi_tpu/ops/aggregators.py"
K7_SRC = "siddhi_tpu_torch/csrc/k7_radix_sort.cu"
WINDOWS_EXTRA = "siddhi_tpu/ops/windows_extra.py"
EXPR_GENERAL = "siddhi_tpu/ops/expression_general.py"
K13A_SRC = "siddhi_tpu_torch/csrc/k13a_expression_walk.cu"
K13B_SRC = "siddhi_tpu_torch/csrc/k13b_frequent.cu"
K13C_SRC = "siddhi_tpu_torch/csrc/k13c_limiter_ring.cu"
RATELIMIT = "siddhi_tpu/ops/ratelimit.py"
SELECTOR = "siddhi_tpu/ops/selector.py"
TABLE = "siddhi_tpu/core/table.py"
K13D_SRC = "siddhi_tpu_torch/csrc/k13d_table_insert.cu"
K13E_SRC = "siddhi_tpu_torch/csrc/k13e_last_match.cu"
AGG = "siddhi_tpu/core/aggregation.py"
K13F_SRC = "siddhi_tpu_torch/csrc/k13f_bucket_scatter.cu"
#: window parameter of apps J-M: ms for the time windows, events for L
AGG_SIZES = {"J": TIME_WINDOW_MS, "K": TIME_WINDOW_MS, "L": LENGTH_D,
             "M": 1_000}

#: launch-counter key -> (function, source, TPU-side function replaced)
KERNELS = {
    "K1": ("stable_partition_order", "siddhi_tpu_torch/csrc/k1_partition.cu",
           "siddhi_tpu/ops/search.py:20"),
    "K3": ("hash_columns", "siddhi_tpu_torch/csrc/k3_hash.cu",
           f"{GROUPBY}:576"),
    "K4": ("key_lookup_or_insert", "siddhi_tpu_torch/csrc/k4_keytable.cu",
           f"{GROUPBY}:362"),
    "K5": ("grouped_scan_fused", K5_SRC, f"{GROUPBY}:171"),
    "K5 ungrouped": ("ungrouped_scan_fused", K5_SRC, f"{GROUPBY}:240"),
    "K2b pack": ("_pack_rows + compact_packed", K2B_SRC, f"{WINDOWS}:295"),
    "K2b fetch": ("_fetch_rel_packed", K2B_SRC, f"{WINDOWS}:374"),
    "K2b append": ("_append_packed", K2B_SRC, f"{WINDOWS}:354"),
    "K2b gather": ("_gather_chunk_packed", K2B_SRC, f"{WINDOWS}:400"),
    "K5b grouped": ("grouped_scan + _scan_component", K5_SRC,
                    f"{GROUPBY}:61"),
    "K5b ungrouped": ("ungrouped_scan", K5_SRC, f"{GROUPBY}:207"),
    "K3b": ("hash_columns32 + _hash_exprs",
            "siddhi_tpu_torch/csrc/k3_hash.cu", f"{GROUPBY}:555"),
    "K10 append": ("multimap_append", K10_SRC, f"{JOIN}:227"),
    "K10 probe": ("multimap_probe", K10_SRC, f"{JOIN}:275"),
    "K10 probe compact": ("multimap_probe + compact_pairs in one launch "
                          "(where the join step compacts)", K10_SRC,
                          f"{JOIN}:275"),
    "K10 compact": ("compact_pairs", K10_SRC, f"{JOIN}:165"),
    "K11a": ("first_match", K11_SRC, f"{PATTERN}:1189"),
    "K7 pattern index": ("match_index's sort (per equality column)",
                         K7_SRC, f"{PATTERN}:1189"),
    "K11b": ("pending_insert", K11_SRC, f"{PATTERN}:1460"),
    "K11c": ("absent_scan", K11C_SRC, f"{PATTERN}:871"),
    "K11d": ("match_count", K11C_SRC, f"{PATTERN}:1318"),
    "K11e": ("release_origin", K11C_SRC, f"{PATTERN}:1440"),
    "K8": ("sliding_extrema_lanes", K8_SRC, "siddhi_tpu/ops/extrema.py:38"),
    "K8 grouped": ("grouped_sliding_extrema_lanes", K8_SRC,
                   "siddhi_tpu/ops/extrema.py:96"),
    "K9 HLL": ("hll:distinctCount register update (custom_scan)", K9_SRC,
               f"{AGGS}:299"),
    "K9 HLL estimate": ("hll:distinctCount _estimate", K9_SRC,
                        f"{AGGS}:289"),
    "K12a": ("_wire_pack + the host compaction",
             "siddhi_tpu_torch/csrc/k12a_wire_pack.cu",
             "siddhi_tpu/core/stream.py:178"),
    "K7 session chunk": ("_sort_chunk (session)", K7_SRC, f"{WINDOWS}:136"),
    "K7 sort chunk": ("_sort_chunk (sort)", K7_SRC, f"{WINDOWS}:136"),
    "K7 rank": ("SortWindow._rank_key", K7_SRC, f"{WINDOWS}:1214"),
    "K7 keyed group": ("KeyedSessionWindow.step key grouping", K7_SRC,
                       f"{WINDOWS_EXTRA}:480"),
    "K7 keyed top-E": ("KeyedSessionWindow.step top-E", K7_SRC,
                       f"{WINDOWS_EXTRA}:542"),
    "K7 packed chunk": ("_sort_chunk_packed (expression windows)", K7_SRC,
                        f"{WINDOWS}:419"),
    "K7 frequent key": ("FrequentWindow.step key sort", K7_SRC,
                        f"{WINDOWS_EXTRA}:277"),
    "K7 frequent match": ("_match slot-key sort", K7_SRC,
                          f"{WINDOWS_EXTRA}:374"),
    "K13a sliding": ("GeneralExpressionWindow._frontiers", K13A_SRC,
                     f"{EXPR_GENERAL}:287"),
    "K13a batch": ("GeneralExpressionBatchWindow.step scan", K13A_SRC,
                   f"{EXPR_GENERAL}:386"),
    "K13b": ("FrequentWindow.step last lane per slot", K13B_SRC,
             f"{WINDOWS_EXTRA}:330"),
    "K13c append": ("BufferedLimiter.step ring append", K13C_SRC,
                    f"{RATELIMIT}:111"),
    "K13c gather": ("BufferedLimiter.step ring gather", K13C_SRC,
                    f"{RATELIMIT}:152"),
    "K13c snapshot append": ("WindowedSnapshotLimiter.step ring append",
                             K13C_SRC, f"{RATELIMIT}:307"),
    "K13c snapshot gather": ("WindowedSnapshotLimiter.step ring gather",
                             K13C_SRC, f"{RATELIMIT}:326"),
    "K13b grouped snapshot": ("GroupedSnapshotLimiter.step last lane per "
                              "slot", K13B_SRC, f"{RATELIMIT}:461"),
    "K7 time-first": ("TimeFirstLimiter.step bucket sort", K7_SRC,
                      f"{RATELIMIT}:195"),
    "K7 order by": ("_order_chunk key sort", K7_SRC, f"{SELECTOR}:535"),
    "K1 order by": ("_order_chunk valid-first partition",
                    "siddhi_tpu_torch/csrc/k1_partition.cu",
                    f"{SELECTOR}:548"),
    "K5b ordinal": ("EventOrdinalLimiter.step ordinal scan", K5_SRC,
                    f"{RATELIMIT}:75"),
    "K5b limit": ("_limit_chunk rank scan", K5_SRC, f"{SELECTOR}:558"),
    "K13d dedup": ("InMemoryTable._make_insert primary-key dedup",
                   K13D_SRC, f"{TABLE}:177"),
    "K13d place": ("InMemoryTable._make_insert placement", K13D_SRC,
                   f"{TABLE}:191"),
    "K13e": ("TableOutputExecutor._make last match, the mask route (and "
             "contains_probe)", K13E_SRC, f"{TABLE}:361"),
    "K13e eq": ("TableOutputExecutor._make last match, the equality route "
                "(an ON condition of == compares)", K13E_SRC,
                f"{TABLE}:361"),
    "K1 table free": ("_make_insert free-row order",
                      "siddhi_tpu_torch/csrc/k1_partition.cu",
                      f"{TABLE}:193"),
    "K7 table index": ("InMemoryTable.probe_indexes sort", K7_SRC,
                       f"{TABLE}:150"),
    "K13b final per group": ("emit_final_per_group last lane per group",
                             K13B_SRC, f"{SELECTOR}:510"),
    "K13f ingest": ("AggregationRuntime._make_ingest scatters", K13F_SRC,
                    f"{AGG}:622"),
    "K13f evict": ("AggregationRuntime._make_evict scatters", K13F_SRC,
                   f"{AGG}:672"),
    "K13f restore": ("AggregationRuntime._restore_fn scatters", K13F_SRC,
                     f"{AGG}:465"),
    "K3 aggregation": ("hash_columns of (bucket, group columns)",
                       "siddhi_tpu_torch/csrc/k3_hash.cu", f"{AGG}:647"),
    "K4 aggregation": ("key_lookup_or_insert into a duration store",
                       "siddhi_tpu_torch/csrc/k4_keytable.cu", f"{AGG}:648"),
    "K12b": ("SuperstepRunner compaction (superstep_pack)",
             "siddhi_tpu_torch/csrc/k12b_superstep_pack.cu",
             "siddhi_tpu/core/superstep.py:417"),
    "K4b": ("dense_key_lookup_or_insert",
            "siddhi_tpu_torch/csrc/k4b_dense_keys.cu", f"{GROUPBY}:500"),
    "K3 partition": ("hash_columns of the partition key",
                     "siddhi_tpu_torch/csrc/k3_hash.cu",
                     "siddhi_tpu/core/partition.py:244"),
    "K6": ("searchsorted32", "siddhi_tpu_torch/csrc/k6_search.cu",
           "siddhi_tpu/ops/search.py:127"),
    "K7 merge": ("_merge_order", "siddhi_tpu_torch/csrc/k7_merge.cu",
                 f"{WINDOWS}:160"),
    "K7 K5 sort": ("stable_argsort_bounded (K5's slot sort)", K7_SRC,
                   "siddhi_tpu/ops/search.py:86"),
    "K7 K5b sort": ("stable_argsort_bounded (K5b's slot sort)", K7_SRC,
                    "siddhi_tpu/ops/search.py:86"),
}
#: rows of the kernel table beyond one a counter: row key -> the counter
#: whose launches it reports (the same kernel at a second shape)
EXTRA_ROWS = {"K2b gather (app D's merge order)": "K2b gather",
              "K13f ingest (10,000 slots)": "K13f ingest",
              "K12b (K = 32)": "K12b",
              "K13e (a table-only condition)": "K13e",
              "K4b (app AJ's first batch)": "K4b",
              "K4b (L = 131072, K = 4096)": "K4b",
              "K7 merge (app C's shape)": "K7 merge",
              "K7 merge (app A's shape)": "K7 merge",
              "K7 merge (app A's shape, expired output)": "K7 merge",
              "K6 (app M's bucket trigger)": "K6"}


class Failure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise Failure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_ms(torch, fn, reset=None, iters=20, warmup=3) -> float:
    """Mean CUDA-event time of fn(); `reset` (untimed) restores any state
    fn mutates before each run."""
    for _ in range(warmup):
        if reset is not None:
            reset()
        fn()
    total = 0.0
    for _ in range(iters):
        if reset is not None:
            reset()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


_SLEEP_CYCLES_PER_MS = []  # torch.cuda._sleep's rate, measured once


def device_ms(torch, fn, iters=20, warmup=3, reset=None) -> float:
    """Mean device time of fn() without its host enqueue: the calls queue
    behind a spin kernel (torch.cuda._sleep) that outlasts their enqueue,
    so the card runs them back to back, each between its own events
    after a 128 MiB fill that leaves L2 cold, as a step's other work
    leaves it, and after `reset()` (untimed; it restores any state fn
    mutates). A fn that reads the card on the host stalls there, and its
    time includes the stall."""
    if not _SLEEP_CYCLES_PER_MS:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(10_000_000)
        e1.record()
        e1.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10_000_000 / e0.elapsed_time(e1))
    # larger than the H100's 50 MB L2; freed on return, so that no later
    # phase's peak memory counts it
    flush = torch.empty(2**25, dtype=torch.int32, device="cuda")
    reset = reset if reset is not None else (lambda: None)
    for _ in range(warmup):
        reset()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        flush.zero_()
        reset()
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(_SLEEP_CYCLES_PER_MS[0]
                          * min(2 * enqueue_ms + 1, 1000)))
    for e0, e1 in events:
        flush.zero_()
        reset()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / iters


def device_busy_ms(torch, fn):
    """The card's busy time over fn(): the union of the kernel, copy and
    fill spans of a torch.profiler (CUPTI) trace; None where the trace
    holds no device span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a >= end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return busy_us / 1e3 if busy_us else None


def scatter_bytes(widx, cols) -> int:
    """The bytes a bucket scatter must move: every lane's slot read, each
    distinct source read at the kept lanes, each touched slot's add, min
    and max columns read and written and its set columns written."""
    import torch
    K = cols[0][0].shape[0]
    keep = (widx >= 0) & (widx < K)
    kept = int(keep.sum())
    touched = int(torch.unique(widx[keep]).numel())
    srcs = {s.data_ptr(): s.element_size() for _, s, _ in cols
            if s is not None}
    slot = sum(d.element_size() * (1 if op in ("set", "true") else 2)
               for d, _, op in cols)
    return widx.numel() * 4 + kept * sum(srcs.values()) + touched * slot


def check_equal(name, a, b) -> None:
    """Bit for bit (floats compared as their bits, so NaN words match)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise Failure(f"{name}: kernel and plain version differ in shape or "
                      "type")
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    if not bool((a == b).all()):
        raise Failure(f"{name}: kernel and plain version differ")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #


def keytable_steady_state(torch, groupby, kernels, table, restore, valid,
                          counter) -> None:
    """K4 on a batch of keys the table holds (a steady-state step: no claim
    wave runs; lane i takes the (7919 i)-th held key) against the plain
    version, timed, with the launches of one call; prints one line."""
    restore()
    count0 = int(table.count)
    held = table.keys[table.keys != (1 << 63) - 1]
    n = valid.shape[0]
    keys = held[(torch.arange(n, device=held.device) * 7919) % held.numel()]
    want = groupby.key_lookup_or_insert_plain(
        groupby.KeyTable(*[t.clone() for t in table]), keys, valid)
    kernels.reset_launch_counts()
    got = groupby.key_lookup_or_insert(table, keys, valid, counter=counter)
    launches = kernels.LAUNCHES[counter]
    for nm, a, b in zip(K4_FIELDS, (*got[0], *got[1:]),
                        (*want[0], *want[1:])):
        check_equal(f"{counter} steady state {nm}", a, b)
    if int(got[0].count) != count0 or not bool(got[2][valid].all()):
        raise Failure(f"{counter} steady state: a present key unresolved")
    row = dict(
        _timed(torch, lambda: groupby.key_lookup_or_insert(
                   table, keys, valid, counter=counter),
               lambda: groupby.key_lookup_or_insert_plain(
                   table, keys, valid), reset=restore),
        # lane I/O and one slot and id read per valid lane
        bound_ms=bound_ms(n * (8 + 1 + 4 + 1) + int(valid.sum()) * 12),
        launches_a_call=launches)
    print(f"{counter} key_lookup_or_insert steady state (L={n}, every key "
          f"present, H={table.keys.shape[0]}): {json.dumps(row)}")


def kernel_phase(torch, rng, chunk_width_a: int) -> dict:
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, search

    dev = torch.device("cuda")
    res = {}

    # K1: compaction of a batch (L = 131072) and a merge group (B + N)
    k1 = {}
    for L in (BATCH, BATCH + WINDOW):
        live = torch.from_numpy(rng.random(L) < 0.7).to(dev)
        got = search.stable_partition_order(live)
        check_equal(f"K1 L={L}", got, search.stable_partition_order_plain(live))
        k1[L] = dict(
            _timed(torch, lambda: search.stable_partition_order(live),
                   lambda: search.stable_partition_order_plain(live),
                   lambda: torch.sort((~live).to(torch.int32), stable=True)),
            bound_ms=bound_ms(L * 1 + L * 4))
        print(f"K1 stable_partition_order L={L}: {k1[L]}")
    res["K1"] = dict(k1[BATCH], max_abs_err=0, bound_by="bytes")

    # K3: one int64 key column of a full batch
    keys = torch.from_numpy(
        rng.integers(-(2**63), 2**63 - 1, BATCH, dtype=np.int64)).to(dev)
    check_equal("K3", groupby.hash_columns([keys]),
                groupby.hash_columns_plain([keys]))
    res["K3"] = dict(
        _timed(torch, lambda: groupby.hash_columns([keys]),
               lambda: groupby.hash_columns_plain([keys])),
        bound_ms=bound_ms(BATCH * 8 * 2), max_abs_err=0, bound_by="bytes")
    print(f"K3 hash_columns n={BATCH}: {res['K3']}")

    # K4: H = 2^21 table (K = 2^20 ids) holding 2^19 keys, then a batch of
    # half present, half new keys
    table = groupby.init_key_table(GROUP_CAP, dev)
    pre = torch.from_numpy(rng.integers(0, 2**62, GROUP_CAP // 2,
                                        dtype=np.int64)).to(dev)
    ones = torch.ones(pre.shape[0], dtype=torch.bool, device=dev)
    table, _, ok = groupby.key_lookup_or_insert(table, pre, ones)
    present = pre[torch.from_numpy(
        rng.integers(0, pre.shape[0], BATCH // 2)).to(dev)]
    fresh = torch.from_numpy(rng.integers(2**62, 2**63 - 1, BATCH // 2,
                                          dtype=np.int64)).to(dev)
    batch_keys = torch.cat([present, fresh])[
        torch.from_numpy(rng.permutation(BATCH)).to(dev)].contiguous()
    valid = torch.from_numpy(rng.random(BATCH) < 0.95).to(dev)
    saved = [t.clone() for t in table]
    count0 = int(table.count)

    def restore():
        for t, s in zip(table, saved):
            t.copy_(s)

    restore()
    p_tab, p_ids, p_res = groupby.key_lookup_or_insert_plain(
        groupby.KeyTable(*[t.clone() for t in saved]), batch_keys, valid)
    restore()
    k_tab, k_ids, k_res = groupby.key_lookup_or_insert(table, batch_keys,
                                                       valid)
    for nm, a, b in (("keys", k_tab.keys, p_tab.keys),
                     ("ids", k_tab.ids, p_tab.ids),
                     ("count", k_tab.count, p_tab.count),
                     ("misses", k_tab.misses, p_tab.misses),
                     ("lane ids", k_ids, p_ids),
                     ("resolved", k_res, p_res)):
        check_equal(f"K4 {nm}", a, b)
    n_new = int(k_tab.count) - count0
    n_valid = int(valid.sum())
    # lane I/O (keys, valid, ids, resolved), one slot + id read per valid
    # lane, one slot + id write per new key
    k4_bytes = BATCH * (8 + 1 + 4 + 1) + n_valid * 12 + n_new * 12
    res["K4"] = dict(
        _timed(torch, lambda: groupby.key_lookup_or_insert(
            table, batch_keys, valid),
            lambda: groupby.key_lookup_or_insert_plain(
                table, batch_keys, valid), reset=restore),
        bound_ms=bound_ms(k4_bytes), max_abs_err=0, bound_by="bytes")
    restore()
    kernels.reset_launch_counts()
    groupby.key_lookup_or_insert(table, batch_keys, valid)
    print(f"K4 key_lookup_or_insert H={2 * GROUP_CAP} prefilled="
          f"{count0} new={n_new}: {res['K4']}; "
          f"{kernels.LAUNCHES['K4']} launch a call")
    keytable_steady_state(torch, groupby, kernels, table, restore, valid,
                          "K4")

    # K5: one lengthBatch(10000) chunk of app A: 13 flushes of [RESET,
    # 10000 CURRENT], the rest invalid; three float32 components
    L = chunk_width_a
    flushes = BATCH // WINDOW
    types = np.full(L, -1)
    for f in range(flushes):
        types[f * (WINDOW + 1)] = 3
        types[f * (WINDOW + 1) + 1:(f + 1) * (WINDOW + 1)] = 0
    resets = torch.from_numpy(types == 3).to(dev)
    data_valid = torch.from_numpy(types == 0).to(dev)
    slots = torch.from_numpy(rng.integers(0, GROUP_CAP, L).astype(
        np.int32)).to(dev)
    price = torch.from_numpy(rng.uniform(1, 100, L).astype(np.float32)).to(dev)
    comps = [price, price.clone(), torch.ones(L, dtype=torch.float32, device=dev)]
    values0 = [torch.from_numpy(rng.uniform(0, 500, GROUP_CAP).astype(
        np.float32)).to(dev) for _ in comps]
    epoch0 = torch.from_numpy(rng.integers(0, 8, GROUP_CAP).astype(
        np.int32)).to(dev)
    cur_epoch = torch.tensor(5, dtype=torch.int32, device=dev)
    values = [v.clone() for v in values0]
    epoch = epoch0.clone()

    def restore5():
        for v, v0 in zip(values, values0):
            v.copy_(v0)
        epoch.copy_(epoch0)

    def run5():
        return groupby.grouped_scan_fused(values, epoch, slots, comps,
                                          data_valid, resets, cur_epoch)

    def plain5():
        return groupby.grouped_scan_fused_plain(values, epoch, slots, comps,
                                                data_valid, resets, cur_epoch)

    restore5()
    pv, pe, po = plain5()
    restore5()
    kv, ke, ko = run5()
    check_equal("K5 epoch", ke, pe)
    err = 0.0
    for a, b in list(zip(kv, pv)) + list(zip(ko, po)):
        if not torch.allclose(a, b, rtol=RTOL, atol=0):
            raise Failure("K5: float components beyond rtol 1e-5")
        err = max(err, float((a - b).abs().max()))
    # exactness of the int64 and float64 instantiations on the same plan
    for dt in (torch.int64, torch.float64):
        d = (price * 7).to(dt)
        v0 = torch.from_numpy(rng.integers(0, 500, GROUP_CAP)).to(dev).to(dt)
        a = groupby.grouped_scan_fused([v0.clone()], epoch0.clone(), slots,
                                       [d], data_valid, resets, cur_epoch)
        b = groupby.grouped_scan_fused_plain([v0.clone()], epoch0.clone(),
                                             slots, [d], data_valid, resets,
                                             cur_epoch)
        if dt == torch.int64:
            check_equal("K5 int64 values", a[0][0], b[0][0])
            check_equal("K5 int64 lanes", a[2][0], b[2][0])
        elif not (torch.allclose(a[0][0], b[0][0], rtol=1e-12, atol=0)
                  and torch.allclose(a[2][0], b[2][0], rtol=1e-12, atol=0)):
            raise Failure("K5 float64 beyond rtol 1e-12")
    touched = int(torch.unique(torch.where(data_valid, slots, -1)).numel()) - 1
    n_comp = len(comps)
    # slots, valid, resets, deltas in; lane outputs out; per touched slot
    # one value read + write per component and one epoch read + write
    k5_bytes = (L * (4 + 1 + 1) + n_comp * L * 4 * 2
                + touched * (n_comp * 8 + 8))
    res["K5"] = dict(
        _timed(torch, run5, plain5, reset=restore5),
        bound_ms=bound_ms(k5_bytes), max_abs_err=err, bound_by="bytes")
    print(f"K5 grouped_scan_fused L={L} comps={n_comp} K={GROUP_CAP}: "
          f"{res['K5']}")
    torch.cuda.synchronize()
    return res


#: K1's one-block limit (csrc/k1_partition.cu TILE)
K1_TILE = 4096


def k1_edge_cases(torch, rng, dev) -> list:
    """(name, live flags) of K1's edges, in the order they run: n = 1, 31,
    the one-block limit and one each side, a batch, a sliding chunk (3B),
    2^20 + 1; every lane live, every lane dead; flags at an odd address
    (byte loads); then a small call right after the largest one (its
    workspace must be left clean)."""
    cases = []
    for n in (1, 31, K1_TILE - 1, K1_TILE, K1_TILE + 1, BATCH, 3 * BATCH,
              (1 << 20) + 1):
        cases.append((f"n={n}", torch.from_numpy(rng.random(n) < 0.6)
                      .to(dev)))
    for n in (K1_TILE + 1, 3 * BATCH):
        cases.append((f"all live n={n}",
                      torch.ones(n, dtype=torch.bool, device=dev)))
        cases.append((f"all dead n={n}",
                      torch.zeros(n, dtype=torch.bool, device=dev)))
    odd = torch.from_numpy(rng.random(BATCH + 1) < 0.5).to(dev)
    cases.append(("odd address n=131072", odd[1:]))
    cases.append(("n=2^20+1 again", cases[7][1]))
    cases.append(("n=31 after 2^20+1", cases[1][1]))
    cases.append(("n=4097 after it", cases[4][1]))
    return cases


def k1_edge_phase(torch, rng) -> None:
    """Phase 2's K1 edges against its plain version, bit for bit, one
    launch a call."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import search
    for name, live in k1_edge_cases(torch, rng, torch.device("cuda")):
        kernels.reset_launch_counts()
        got = search.stable_partition_order(live)
        if kernels.LAUNCHES["K1"] != 1:
            raise Failure(f"K1 edge {name}: {kernels.LAUNCHES['K1']} "
                          "launches, one a call expected")
        check_equal(f"K1 edge {name}", got,
                    search.stable_partition_order_plain(live))
    print("K1 edges: every case bit for bit, one launch a call")


def k4_edge_cases(torch, rng, dev, K: int = GROUP_CAP, L: int = BATCH,
                  L_huge: int = 1 << 20) -> dict:
    """name -> (table, keys, valid) of K4's edges: a steady-state batch
    (every key present) into a 2K-slot table holding K/2 keys, every lane
    new, every lane one new key, the pad key beside INT64_MAX - 1, one
    lane, L_huge lanes (half of them new: the id space runs out); a
    contended 128-slot table where lanes still need a slot after the fifth
    wave; a 2,048-slot table 24 ids short of its limit, given 100 new
    keys (the rest revert). 95% of the lanes valid but where named."""
    from siddhi_tpu_torch.ops import groupby
    PAD = (1 << 63) - 1

    def table_with(k, pre):
        t = groupby.init_key_table(k, dev)
        if pre.shape[0]:
            t, _, _ = groupby.key_lookup_or_insert_plain(
                t, pre, torch.ones(pre.shape[0], dtype=torch.bool,
                                   device=dev))
        return t

    def keys_of(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

    def valid(n, p=0.95):
        return torch.from_numpy(rng.random(n) < p).to(dev)

    pre = rng.integers(0, 2**62, K // 2, dtype=np.int64)
    big = table_with(K, keys_of(pre))

    def fresh(n):
        return rng.integers(2**62, PAD - 1, n, dtype=np.int64)

    pad = pre[rng.integers(0, pre.size, L)]
    pad[rng.random(L) < 0.5] = PAD
    pad[rng.random(L) < 0.2] = PAD - 1
    huge = np.where(rng.random(L_huge) < 0.5, pre[rng.integers(
        0, pre.size, L_huge)], fresh(L_huge))
    few = rng.integers(0, 2**40, 300)
    near = rng.integers(0, 2**40, 1000)
    return {
        "steady state": (big, keys_of(pre[rng.integers(0, pre.size, L)]),
                         valid(L)),
        "every lane new": (big, keys_of(fresh(L)), valid(L)),
        "every lane one new key": (big, keys_of(np.full(L, fresh(1)[0])),
                                   valid(L)),
        "the pad key": (big, keys_of(pad), valid(L)),
        "L = 1": (big, keys_of(fresh(1)), valid(1, 1.0)),
        "L = 2^20": (big, keys_of(huge), valid(L_huge)),
        "contended small table": (table_with(64, keys_of([])),
                                  keys_of(few[rng.integers(0, 300, 400)]),
                                  valid(400, 0.9)),
        "id-limit revert": (table_with(1024, keys_of(near)),
                            keys_of(np.concatenate(
                                [fresh(100), near[:50]])[
                                rng.permutation(150)]), valid(150, 1.0)),
    }


def run_k4_case(groupby, case, plain: bool, counter: str = "K4"):
    """(table fields..., ids, resolved) after the case's call on a copy of
    its table, by the kernel or by the plain version."""
    table, keys, valid = case
    t = groupby.KeyTable(*[x.clone() for x in table])
    if plain:
        t, ids, res = groupby.key_lookup_or_insert_plain(t, keys, valid)
    else:
        t, ids, res = groupby.key_lookup_or_insert(t, keys, valid,
                                                   counter=counter)
    return (*t, ids, res)


K4_FIELDS = ("keys", "ids", "count", "misses", "lane ids", "resolved")


def keytable_edge_phase(torch, rng) -> None:
    """Phase 2's K4 edges against the plain version, the table state, lane
    ids, resolved, count and misses bit for bit, one launch a call; a
    small table right after a large one on one stream."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    cases = k4_edge_cases(torch, rng, torch.device("cuda"))
    order = list(cases) + ["L = 2^20", "contended small table", "L = 2^20",
                           "L = 1"]
    for name in order:
        kernels.reset_launch_counts()
        got = run_k4_case(groupby, cases[name], plain=False)
        if kernels.LAUNCHES["K4"] != 1:
            raise Failure(f"K4 edge {name}: {kernels.LAUNCHES['K4']} "
                          "launches, one a call expected")
        for f, a, b in zip(K4_FIELDS, got,
                           run_k4_case(groupby, cases[name], plain=True)):
            check_equal(f"K4 edge {name} {f}", a, b)
    print(f"K4 edges: {len(cases)} cases bit for bit, one launch a call "
          "(small tables right after large ones)")


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_float_scan(name, a, b) -> float:
    """A float32 sum scan against its plain version: the two add in other
    orders, so they differ by rounding of the running sums, not of each
    lane's value (a lane near a zero crossing holds far less than the sums
    it came from). Tolerance: rtol 1e-5 of the largest running value."""
    err = _err(a, b)
    scale = max(float(b.double().abs().max()), 1.0)
    if err > RTOL * scale:
        raise Failure(f"{name}: off by {err} (> {RTOL} x {scale})")
    return err


#: library calls that read the card on the host (their device_ms holds
#: the stall); printed before the kernel table, none expected
LIBRARY_SYNCS: list = []


def _library_ms(torch, library, reset=None):
    """The library call's device time (device_ms), after one watched call
    that records any host sync it makes in LIBRARY_SYNCS."""
    if library is None:
        return None
    if reset is not None:
        reset()
    _, syncs = call_watching_syncs(torch, library)
    if syncs:
        LIBRARY_SYNCS.append(syncs)
    return device_ms(torch, library, reset=reset)


def _timed(torch, fn, plain, library=None, reset=None) -> dict:
    """The kernel's and the library call's times on the device alone
    (device_ms), the plain version's with its host enqueue (time_ms: most
    plain versions read the card on the host), and `call_ms`, one kernel
    call with its host enqueue, as a step pays it."""
    return dict(ms=device_ms(torch, fn, reset=reset),
                plain_ms=time_ms(torch, plain, reset=reset),
                library_ms=_library_ms(torch, library, reset),
                call_ms=time_ms(torch, fn, reset=reset))


def _timed_device(torch, fn, plain, library=None) -> dict:
    """_timed's times by device_ms, and `call_ms`, one call's time with
    its host enqueue (time_ms), as a step pays it."""
    return dict(ms=device_ms(torch, fn), plain_ms=device_ms(torch, plain),
                library_ms=_library_ms(torch, library),
                call_ms=time_ms(torch, fn))


def _k11a_case(torch, rng, dev, B, P, kinds=("i32",), n_values=6,
               p_valid=0.9, fill=0.6, within=300, ts_kind="sorted",
               match="some", residual=False, seq0=70_000):
    """(args, kw) of first_match: a batch of B arrivals, a P-slot table
    `fill` full, equality columns of `kinds` (bool, i32, i64 with negative
    and extreme values) over n_values values; ts sorted, unsorted (so that
    `within` fails on a lane and passes on a later one) or wild (near the
    int64 extremes, where differences wrap); entries whose captured values
    are drawn from the batch's ("some"), all taken from matching lanes
    ("all": every live entry matches) or absent from it ("none")."""
    valid = rng.random(B) < p_valid
    arr_seq = np.where(valid, seq0 + np.cumsum(valid) - 1, 2**62)
    if ts_kind == "sorted":
        ts = 10_000 + np.arange(B) // 4
    elif ts_kind == "unsorted":
        ts = 10_000 + rng.integers(0, 600, B)
    else:
        ts = rng.choice([-2**63, -2**62 - 5, 0, 2**62 - 7, 2**63 - 1], B)
    lane_ok = valid & (rng.random(B) < 0.85)
    pend_valid = rng.random(P) < fill
    last_seq = np.where(rng.random(P) < 0.5,
                        seq0 - 1 + rng.integers(-2, B + 2, P),
                        seq0 - 1 - rng.integers(0, 99, P))
    start_ts = 10_000 - rng.integers(-50, 400, P)
    if ts_kind == "wild":
        start_ts = rng.choice([-2**63, -3, 2**62, 2**63 - 1], P)
    pick = rng.integers(0, B, P)  # the lane each entry copies its values of
    eq = []
    for k in kinds:
        if k == "bool":
            a = rng.random(B) < 0.5
        elif k == "i32":
            a = rng.integers(-n_values, n_values, B).astype(np.int32)
        else:
            a = np.array([-2**63, -2**40, -1, 0, 5, 2**40, 2**63 - 1],
                         np.int64)[rng.integers(0, min(7, 2 * n_values), B)]
        eq.append([a, a[pick]])
    if match == "none":  # the first column's captured values miss the batch
        a = eq[0][0]
        if a.dtype == bool:
            a[:] = True
            eq[0][1] = np.zeros(P, bool)
        else:  # above every i32 value drawn, outside the i64 set
            eq[0][1] = np.full(P, 6 if a.dtype == np.int64 else n_values + 1,
                               a.dtype)
    if match == "all":  # every entry takes an ok lane's values, before it
        ok = np.flatnonzero(lane_ok)
        pick = ok[rng.integers(0, ok.size, P)]
        for col in eq:
            col[1] = col[0][pick]
        last_seq = arr_seq[pick] - 1
        start_ts = ts[pick] - rng.integers(0, within + 1, P)
    T = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in (
        ("arr_seq", arr_seq.astype(np.int64)), ("ts", ts.astype(np.int64)),
        ("valid", valid), ("lane_ok", lane_ok), ("pend_valid", pend_valid),
        ("last_seq", last_seq.astype(np.int64)),
        ("start_ts", start_ts.astype(np.int64)))}
    pairs = [(torch.from_numpy(np.ascontiguousarray(a)).to(dev),
              torch.from_numpy(np.ascontiguousarray(e)).to(dev))
             for a, e in eq]
    res = None
    if residual:
        r = torch.from_numpy(rng.random((B, P)) < 0.7).to(dev)

        def res(p0, p1):
            return r[:, p0:p1]
    args = (T["arr_seq"], T["ts"], T["valid"], T["lane_ok"], pairs,
            T["pend_valid"], T["last_seq"], T["start_ts"], within, False)
    kw = dict(seq0=torch.tensor(seq0, dtype=torch.int64, device=dev),
              residual=res, tile=700)
    return args, kw


def k11a_edge_cases(torch, rng, dev):
    """name -> (args, kw) of first_match at its edges: no equality and one
    to four columns of bool, int32 and int64 (negative and extreme
    values), runs far longer than a warp, every entry matching and none,
    `within` failing on a lane with
    a later lane passing, wild timestamps, residual tiles, dead entries,
    sequence mode, P = 0, B = 1 and no valid lane."""
    c = {}
    c["no equality"] = _k11a_case(torch, rng, dev, 3000, 2000, kinds=())
    c["bool"] = _k11a_case(torch, rng, dev, 3000, 2000, kinds=("bool",))
    c["int32 x2"] = _k11a_case(torch, rng, dev, 3000, 2000,
                               kinds=("i32", "i32"))
    c["int64 negative"] = _k11a_case(torch, rng, dev, 3000, 2000,
                                     kinds=("i64",), n_values=4)
    c["four columns"] = _k11a_case(torch, rng, dev, 3000, 2000,
                                   kinds=("bool", "i32", "i64", "i64"),
                                   n_values=2)
    c["long runs, unsorted ts"] = _k11a_case(
        torch, rng, dev, 5000, 3000, kinds=("i32",), n_values=1,
        within=40, ts_kind="unsorted")
    c["within fails then passes"] = _k11a_case(
        torch, rng, dev, 3000, 3000, kinds=("i32",), n_values=3,
        within=100, ts_kind="unsorted")
    c["every entry matches"] = _k11a_case(
        torch, rng, dev, 3000, 2000, kinds=("i64", "bool"), match="all")
    c["no entry matches"] = _k11a_case(torch, rng, dev, 3000, 2000,
                                       kinds=("i32",), match="none")
    c["wild ts"] = _k11a_case(torch, rng, dev, 2000, 1500, kinds=("i32",),
                              n_values=2, ts_kind="wild")
    c["residual tiles"] = _k11a_case(torch, rng, dev, 1500, 3000,
                                     kinds=("i32", "bool"), residual=True)
    c["dead entries"] = _k11a_case(torch, rng, dev, 3000, 3000,
                                   kinds=("i32",), fill=0.05)
    args, kw = _k11a_case(torch, rng, dev, 3000, 3000, kinds=("i32",))
    live = args[5] & torch.from_numpy(rng.random(3000) < 0.5).to(dev)
    c["live mask"] = (args[:5] + (live,) + args[6:], kw)
    for res in (False, True):
        args, kw = _k11a_case(torch, rng, dev, 1500, 3000, kinds=("i32",),
                              n_values=2, residual=res)
        nxt = (kw["seq0"] - 1 + torch.from_numpy(
            rng.integers(-3, 1503, 3000)).to(dev))
        c[f"sequence{' residual' if res else ''}"] = (
            args[:6] + (nxt,) + args[7:9] + (True,), kw)
    c["P = 0"] = _k11a_case(torch, rng, dev, 500, 0)
    c["B = 1"] = _k11a_case(torch, rng, dev, 1, 700, n_values=1)
    c["no valid lane"] = _k11a_case(torch, rng, dev, 900, 700, p_valid=0.0)
    return c


#: the batches of phase 33's K11c and K11d cases (_k11a_case's arguments)
K11CD_BASES = {
    "no equality": dict(B=3000, P=2000, kinds=()),
    "bool": dict(B=3000, P=2000, kinds=("bool",)),
    "int32 x2": dict(B=3000, P=2000, kinds=("i32", "i32")),
    "int64 negative": dict(B=3000, P=2000, kinds=("i64",), n_values=4),
    "four columns": dict(B=3000, P=2000, kinds=("bool", "i32", "i64", "i64"),
                         n_values=2),
    "long runs, unsorted ts": dict(B=5000, P=3000, kinds=("i32",),
                                   n_values=1, within=40,
                                   ts_kind="unsorted"),
    "no equality, unsorted ts": dict(B=5000, P=3000, kinds=(), within=40,
                                     ts_kind="unsorted"),
    "within fails then passes": dict(B=3000, P=3000, kinds=("i32",),
                                     n_values=3, within=100,
                                     ts_kind="unsorted"),
    "every entry matches": dict(B=3000, P=2000, kinds=("i64", "bool"),
                                match="all"),
    "no entry matches": dict(B=3000, P=2000, kinds=("i32",), match="none"),
    "wild ts": dict(B=2000, P=1500, kinds=("i32",), n_values=2,
                    ts_kind="wild"),
    "residual tiles": dict(B=1500, P=3000, kinds=("i32", "bool"),
                           residual=True),
    "long runs, residual tiles": dict(B=3000, P=3000, kinds=("i32",),
                                      n_values=1, within=40,
                                      ts_kind="unsorted", residual=True),
    "dead entries": dict(B=3000, P=3000, kinds=("i32",), fill=0.05),
    "P = 0": dict(B=500, P=0),
    "B = 1": dict(B=1, P=700, n_values=1),
    "no valid lane": dict(B=900, P=700, p_valid=0.0),
}


def k11cd_edge_cases(torch, rng, dev):
    """name -> (kernel, args, kw) of absent_scan ("K11c") and match_count
    ("K11d") at their edges, on _k11a_case's batches (K11CD_BASES): no
    equality and one to four columns of bool, int32 and int64 (negative
    and extreme values), long runs (two values, or no equality: every
    lane_ok lane) with unsorted ts, `within` failing mid-run then passing,
    every entry matching and none, timestamps near the int64 extremes
    (ts - start_ts wraps), residual tiles of 700 entries (p0 > 0), dead
    entries, P = 0, B = 1 and no valid lane. Each batch gives K11c with
    deadlines drawn from its own timestamps (both sides of each run) and
    untimed, and K11d with and without `within`."""
    c = {}
    for name, base in K11CD_BASES.items():
        args, kw = _k11a_case(torch, rng, dev, **base)
        arr_seq, ts, _, lane_ok, pairs, pend_valid, last_seq, start_ts, \
            within, _ = args
        P = pend_valid.shape[0]
        ts_np = ts.cpu().numpy()
        deadline = torch.from_numpy(
            rng.choice(ts_np, P) + rng.integers(-1, 2, P)).to(dev)
        kw = dict(residual=kw["residual"], tile=kw["tile"])
        batch = (arr_seq, ts, lane_ok, pairs, pend_valid, last_seq)
        c[f"K11c {name}, deadline"] = ("K11c", batch + (deadline,), kw)
        c[f"K11c {name}, untimed"] = ("K11c", batch + (None,), kw)
        c[f"K11d {name}, within"] = ("K11d", batch + (start_ts, within), kw)
        c[f"K11d {name}, no within"] = ("K11d", batch + (start_ts, None), kw)
    return c


def k11cd_launches(args, kw) -> tuple:
    """(probe launches, index launches) of one K11c or K11d call that
    builds its own index: one probe a residual tile (one without), and the
    index's gather wherever there is an entry and a lane."""
    B, P = args[0].shape[0], args[4].shape[0]
    probes = -(-P // kw["tile"]) if kw["residual"] else min(P, 1)
    return probes, int(bool(P and B))


def run_k11cd_case(pattern, case, plain: bool, index=None):
    kernel, args, kw = case
    if kernel == "K11c":
        if plain:
            return pattern.absent_scan_plain(*args, **kw)
        return pattern.absent_scan(*args, **kw, index=index)
    if plain:
        return (pattern.match_count_plain(*args, **kw),)
    return (pattern.match_count(*args, **kw, index=index),)


def _k13a_env(torch, cond, data: dict, dev):
    """The metric arrays of a condition over value sequences `data`."""
    env = {}
    for kind, attr in cond.program.arrays:
        seq = data[attr]
        seq = {"seq": seq, "prefix": np.r_[0.0, np.cumsum(seq)],
               "prefix_sq": np.r_[0.0, np.cumsum(seq * seq)]}[kind]
        env[(kind, attr)] = torch.from_numpy(np.ascontiguousarray(
            seq)).to(dev)
    return env


def k13a_edge_cases(torch, rng, dev):
    """name -> (mode, cond, env, winlen0, n_valid, B, E or include_trigger)
    of K13a at its edges: a condition true on every check (no pop) and one
    false on every check (pops to the empty window, to the E cap), a walk
    whose 2B + E + 8 cap bites (E below -2B), NaN means of an empty window,
    pop chains longer than a band and a chain tile, frontiers that move
    0, 1 and several rows an arrival across tile edges, expressionBatch
    flushes on an empty window with the trigger in and out, and n_valid
    inside a tile, at sizes around the tiles (60 arrivals, 512 checks).
    With n_valid <= B the cap can bite only when E < -2B + n_valid: every
    pop then stops at once, so it lands after an add-check or a pop."""
    from siddhi_tpu_torch.ops import expression_general as eg
    layout = {"price": torch.float64, "volume": torch.int64,
              "spiky": torch.int64}
    n = 4096
    spikes = rng.integers(1, 9, n).astype(np.float64)
    spikes[rng.choice(n, 12, replace=False)] = 400.0  # long pop chains
    data = {"price": rng.integers(-400, 900, n) / 64.0,
            "volume": rng.integers(1, 9, n).astype(np.float64),
            "spiky": spikes}
    out = {}

    def add(name, text, B, w0, nv, modes=(0, 1), E=None, inc=(0, 1)):
        win = eg.GeneralExpressionWindow(layout, B, text)
        env = _k13a_env(torch, win.cond, data, dev)
        a = (torch.tensor(w0, dtype=torch.int32, device=dev),
             torch.tensor(nv, dtype=torch.int32, device=dev))
        if 0 in modes:
            out[f"sliding {name} B={B} w0={w0} nv={nv}"] = (
                0, win.cond, env, *a, B, win.E if E is None else E)
        if 1 in modes:
            for i in inc:
                out[f"batch {name} B={B} w0={w0} nv={nv} inc={i}"] = (
                    1, win.cond, env, *a, B, bool(i))

    for B in (1, 59, 60, 61, 121, 511, 512, 513, 1100):
        add("true", "count() >= 1", B, 300, B)
        add("false", "count() < 1", B, 0, B)
        add("false", "count() < 1", B, 5, max(B - 9, 0))
        add("sum", "sum(volume) <= 60", B, 200, B)
    add("false, E cap", "count() < 1", 300, 900, 300, modes=(0,), E=37)
    for k in (0, 3, 4, 9):  # max_iter = 8 + k checks: the cap bites
        add(f"cap {8 + k}", "sum(volume) <= 60", 200, 150, 200, modes=(0,),
            E=-400 + k)
        add(f"cap {8 + k} current", "price > 3.0 and count() < 9", 200, 150,
            200, modes=(0,), E=-400 + k)
    add("nan", "avg(price) > 1000.0", 600, 40, 600)
    add("stdDev nan", "stdDev(price) < 3.0 and count() < 40", 600, 40, 590)
    add("one a row", "count() <= 40", 700, 40, 700)
    add("signed sums", "sum(price) <= 100.0", 700, 100, 700)
    add("long chains", "sum(spiky) <= 500", 1500, 1000, 1500)
    add("chain tile", "sum(spiky) <= 30", 1500, 2500, 1500)
    add("current", "price > 3.0 or count() < 5", 900, 300, 880)
    add("first and last", "(last.price - first.price) % -7.5 < 3.0", 900,
        300, 900)
    add("empty flushes", "sum(price) < 2.0", 1100, 0, 1100, modes=(1,))
    add("nv in a tile", "sum(volume) <= 60", 1100, 10, 700)
    add("nv = 0", "sum(volume) <= 60", 300, 10, 0)
    return out


def run_k13a_case(eg, case, plain: bool):
    mode, cond, env, w0, nv, B, x = case
    if mode == 0:
        walk = eg.sliding_walk_plain if plain else eg.sliding_walk
        return walk(cond, env, w0, nv, B, x)
    walk = eg.batch_walk_plain if plain else eg.batch_walk
    return walk(cond, env, w0, nv, B, x)


def pattern_walk_edge_phase(torch, rng) -> None:
    """Phase 32: K11a and K13a at their edges against their plain versions,
    bit for bit, and their launches a call (see the module docstring)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import expression_general as eg
    from siddhi_tpu_torch.ops import pattern

    dev = torch.device("cuda")
    n_match = 0
    for name, (args, kw) in k11a_edge_cases(torch, rng, dev).items():
        kernels.reset_launch_counts()
        got = pattern.first_match(*args, **kw)
        want = pattern.first_match_plain(*args, **kw)
        for f, g, w in zip(("b_star", "matched", "killed"), got, want):
            check_equal(f"K11a edge {name} {f}", g, w)
        P = args[5].shape[0]
        tiles = -(-P // kw["tile"]) if kw["residual"] else min(P, 1)
        sequence = args[9]
        want_launches = tiles + (0 if sequence or not P
                                 or not args[0].shape[0] else 1)
        if kernels.LAUNCHES["K11a"] != want_launches:
            raise Failure(f"K11a edge {name}: {kernels.LAUNCHES['K11a']} "
                          f"launches, the counter's formula says "
                          f"{want_launches}")
        n_match += int(got[1].sum())
    print(f"K11a edges: every case bit for bit, {n_match} matches")
    cases = k13a_edge_cases(torch, rng, dev)
    for name, case in cases.items():
        kernels.reset_launch_counts()
        got = run_k13a_case(eg, case, plain=False)
        counter = "K13a sliding" if case[0] == 0 else "K13a batch"
        if kernels.LAUNCHES[counter] != 1:
            raise Failure(f"K13a edge {name}: {kernels.LAUNCHES[counter]} "
                          "launches, one a call expected")
        for i, (g, w) in enumerate(zip(got, run_k13a_case(eg, case, True))):
            check_equal(f"K13a edge {name} output {i}", g, w)
    print(f"K13a edges: {len(cases)} cases bit for bit, one launch a call")


def pattern_probe_edge_phase(torch, rng) -> None:
    """Phase 33: K11c and K11d at their edges against their plain
    versions, bit for bit, with their launches a call, each case once with
    its own index and once probing an index built beforehand (no index
    launch then; see the module docstring)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import pattern

    dev = torch.device("cuda")
    seen = {}
    for name, case in k11cd_edge_cases(torch, rng, dev).items():
        kernel, args, kw = case
        want = run_k11cd_case(pattern, case, plain=True)
        probes, index = k11cd_launches(args, kw)
        n_eq = len(args[3])
        shared = pattern.match_index(args[0], args[1], args[2],
                                     [a for a, _ in args[3]])
        for idx in (None, shared):
            kernels.reset_launch_counts()
            got = run_k11cd_case(pattern, case, plain=False, index=idx)
            for i, (g, w) in enumerate(zip(got, want)):
                check_equal(f"{name} output {i}", g, w)
            built = index if idx is None else 0
            counts = (kernels.LAUNCHES[kernel],
                      kernels.LAUNCHES["K7 pattern index"])
            if counts != (probes + built, n_eq * built):
                raise Failure(f"{name}: (probe + index, K7) launches "
                              f"{counts}, the counters' formula says "
                              f"{(probes + built, n_eq * built)}")
        seen[name] = (tuple(int((x < 2**62).sum()) if x.dtype == torch.int64
                            else int(x.sum()) for x in got)
                      if kernel == "K11c" else int(got[0]))
    print(f"K11c (found, before, after) and K11d counts at their edges, "
          f"bit for bit: {seen}")
    for name in ("K11c long runs, unsorted ts, deadline",
                 "K11c no equality, unsorted ts, deadline",
                 "K11c within fails then passes, deadline"):
        if not (seen[name][1] and seen[name][2]):
            raise Failure(f"{name}: no hit on one side of the deadlines")
    if not seen["K11d within fails then passes, within"]:
        raise Failure("K11d: `within` passes on no pair")


def scan_sort_edge_phase(torch, rng) -> None:
    """Phase 31: K5/K5b and K7 at their edge shapes against their plain
    versions, float-sum determinism, launches a call (see the module
    docstring)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, search

    dev = torch.device("cuda")
    tile = kernels.library("k5_grouped_scan").k5_tile_lanes(0)
    K = 50
    dtypes = (torch.float32, torch.float64, torch.int64, torch.int32)

    def values(dt, n):
        if dt.is_floating_point:
            return torch.from_numpy(rng.uniform(-100, 100, n)).to(dt)
        return torch.from_numpy(rng.integers(-50, 50, n)).to(dt)

    def same(name, a, b, dt, op):
        if dt.is_floating_point and op == "sum":
            check_float_scan(name, a.cpu(), b)
        else:
            check_equal(name, a.cpu(), b)

    def launches(counter, want, name):
        if kernels.LAUNCHES[counter] != want:
            raise Failure(f"{name}: {kernels.LAUNCHES[counter]} launches, "
                          f"the counter's formula says {want}")

    sizes = (1, tile - 1, tile, tile + 1, 3 * tile + 5)
    for n in sizes:
        edges = np.zeros(n, bool)
        edges[::tile] = True
        for layout in ("random", "spanning"):
            if layout == "random":
                slots = torch.from_numpy(rng.integers(0, K, n)
                                         .astype(np.int32))
                resets = torch.from_numpy((rng.random(n) < 0.001) | edges)
            else:  # one segment across every tile
                slots = torch.full((n,), 7, dtype=torch.int32)
                resets = torch.zeros(n, dtype=torch.bool)
            valid = torch.from_numpy(rng.random(n) < 0.9)
            cur = torch.tensor(3, dtype=torch.int32)
            for dt in dtypes:
                d = values(dt, n)
                v0 = values(dt, K)
                e0 = torch.from_numpy(rng.integers(2, 5, K).astype(np.int32))
                for op in ("sum", "min", "max"):
                    name = f"K5b edge n={n} {layout} {op} {dt}"
                    args = (slots, d, valid, resets, cur)
                    ps, po = groupby.grouped_scan_plain(
                        groupby.GroupState(v0.clone(), e0.clone()), *args,
                        op)
                    kernels.reset_launch_counts()
                    ks, ko = groupby.grouped_scan(
                        groupby.GroupState(v0.to(dev), e0.to(dev)),
                        *[a.to(dev) for a in args], op)
                    launches("K5b grouped", 1, name)
                    check_equal(f"{name} epoch", ks.epoch.cpu(), ps.epoch)
                    same(f"{name} values", ks.values, ps.values, dt, op)
                    same(f"{name} lanes", ko, po, dt, op)
                    for live in (3, 2):  # a live and a dead cell epoch
                        ec = torch.tensor([live], dtype=torch.int32)
                        uargs = (d, valid, resets, cur)
                        pu, puo = groupby.ungrouped_scan_plain(
                            groupby.GroupState(v0[:1].clone(), ec.clone()),
                            *uargs, op)
                        kernels.reset_launch_counts()
                        ku, kuo = groupby.ungrouped_scan(
                            groupby.GroupState(v0[:1].to(dev), ec.to(dev)),
                            *[a.to(dev) for a in uargs], op)
                        launches("K5b ungrouped", 1, name)
                        check_equal(f"{name} cell epoch", ku.epoch.cpu(),
                                    pu.epoch)
                        same(f"{name} cell", ku.values, pu.values, dt, op)
                        same(f"{name} ungrouped lanes", kuo, puo, dt, op)
            comps = [values(dt, n) for dt in (torch.float32, torch.int64,
                                              torch.int32)]
            v0 = [values(c.dtype, K) for c in comps]
            e0 = torch.from_numpy(rng.integers(2, 5, K).astype(np.int32))
            lanes = (valid, resets, cur)
            for plain, card, cells, ep, pre, counter in (
                    (groupby.grouped_scan_fused_plain,
                     groupby.grouped_scan_fused, v0, e0, (slots,), "K5"),
                    (groupby.ungrouped_scan_fused_plain,
                     groupby.ungrouped_scan_fused, [v[:1] for v in v0],
                     torch.tensor([3], dtype=torch.int32), (),
                     "K5 ungrouped")):
                name = f"{counter} edge n={n} {layout}"
                pv, pe, po = plain([v.clone() for v in cells], ep.clone(),
                                   *pre, comps, *lanes)
                kernels.reset_launch_counts()
                kv, ke, ko = card([v.to(dev) for v in cells], ep.to(dev),
                                  *[a.to(dev) for a in pre],
                                  [c.to(dev) for c in comps],
                                  *[a.to(dev) for a in lanes])
                launches(counter, 1, name)  # up to four sums a launch
                check_equal(f"{name} epoch", ke.cpu(), pe)
                for c, comp in enumerate(comps):
                    same(f"{name} values {c}", kv[c], pv[c], comp.dtype,
                         "sum")
                    same(f"{name} lanes {c}", ko[c], po[c], comp.dtype,
                         "sum")
        mask = torch.from_numpy(rng.random(n) < 0.97)
        for dt, base in ((torch.int32, None),
                         (torch.int64, torch.tensor(2**40 + 3))):
            pc, pt = groupby.running_count_plain(mask, base, dt)
            kernels.reset_launch_counts()
            kc, kt = groupby.running_count(
                mask.to(dev), counter="K5b limit",
                base=None if base is None else base.to(dev), dtype=dt)
            launches("K5b limit", 1, f"running count n={n}")
            check_equal(f"running count n={n} {dt}", kc.cpu(), pc)
            check_equal(f"running count n={n} {dt} total",
                        kt.reshape(1).cpu(), pt.reshape(1))
    print(f"K5/K5b edge shapes n in {sizes}: integers, min, max bit for "
          "bit; float sums within rtol 1e-5; one launch a component")

    # float sums: the same inputs give the same bits
    L, Kg = 2 * BATCH, GROUP_CAP
    slots = torch.from_numpy(rng.integers(0, Kg, L).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(dev)
    no_resets = torch.zeros(L, dtype=torch.bool, device=dev)
    cur = torch.zeros((), dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.float64):
        d = torch.from_numpy(rng.normal(size=L) * 1e3).to(dt).to(dev)
        runs = []
        for _ in range(2):
            st = groupby.init_group_state(Kg, dt, dev)
            st, o = groupby.grouped_scan(st, slots, d, valid, no_resets, cur)
            cell = groupby.init_group_state(1, dt, dev)
            cell, u = groupby.ungrouped_scan(cell, d, valid, no_resets, cur)
            fv, _, fo = groupby.grouped_scan_fused(
                [torch.zeros(Kg, dtype=dt, device=dev)],
                torch.zeros(Kg, dtype=torch.int32, device=dev), slots, [d],
                valid, no_resets, cur)
            runs.append((o, st.values, u, cell.values, fo[0], fv[0]))
        for i, (a, b) in enumerate(zip(*runs)):
            check_equal(f"K5 {dt} sum run twice ({i})", a, b)
    print(f"K5/K5b float32 and float64 sums at L={L}: bit-identical across "
          "two runs")

    small = kernels.bind("k7_radix_sort", "k7_small_max", [])()
    ktile = kernels.bind("k7_radix_sort", "k7_tile_keys", [])()

    def k7_keys(kind, n):
        if kind == "u32":
            return rng.integers(0, 1 << 20, n).astype(np.int32), (1 << 20) - 1
        if kind == "i32":
            k = rng.integers(-2**31, 2**31, n).astype(np.int32)
            k[rng.integers(0, n, max(1, n // 50))] = -2**31
            k[rng.integers(0, n, max(1, n // 50))] = 2**31 - 1
            return k, None
        if kind == "i64":
            k = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
            k[rng.integers(0, n, max(1, n // 50))] = -2**63
            k[rng.integers(0, n, max(1, n // 50))] = 2**63 - 1
            return k, None
        if kind == "i64 some digits":  # bytes 1 and 4 vary
            return ((rng.integers(0, 256, n, dtype=np.int64) << 8)
                    | (rng.integers(0, 4, n, dtype=np.int64) << 32)
                    | (-7 << 48)), None
        if kind == "i64 equal":
            return np.full(n, -123456789012, np.int64), None
        if kind == "u32 equal":
            return np.full(n, 77, np.int32), 1000
        return np.full(n, -5, np.int32), None  # i32 equal

    # past the grid: more tiles than the cooperative sweep holds at once,
    # so a block walks several
    cap = kernels.bind("k7_radix_sort", "k7_grid_capacity",
                       [ctypes.c_int])(8)
    k7_sizes = (1, ktile - 1, ktile, ktile + 1, 3 * ktile + 5, small,
                small + 1, (cap + 1) * ktile + 7)
    for n in k7_sizes:
        for kind in ("u32", "i32", "i64", "i64 some digits", "i64 equal",
                     "u32 equal", "i32 equal"):
            keys, bound = k7_keys(kind, n)
            k = torch.from_numpy(keys).to(dev)
            for width in (n, n // 3):
                kernels.reset_launch_counts()
                got = search.stable_radix_argsort(k, bound, width,
                                                  counter="K7 rank")
                check_equal(f"K7 edge n={n} {kind} width={width}", got,
                            search.stable_radix_argsort_plain(k, bound,
                                                              width))
                launches("K7 rank", 1, f"K7 edge n={n} {kind}")
    print(f"K7 edge shapes n in {k7_sizes}: bit for bit, launches as "
          "counted")
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# phases 6 and 36: the windows' merge and searches (K7 merge, K6, K7's
# bounded argsort at K5's and K5b's slot sorts)
# --------------------------------------------------------------------------- #

BIG_KEY = 2**62  # ops/windows.py BIG: the merge's pad, the trigger's pad
INT32_MAX = 2**31 - 1
#: the K7 merge's edge cases (their names; `merge_edge_cases` builds them)
MERGE_EDGES = ("ties across three groups", "every lane invalid",
               "every lane valid, one key", "first group empty",
               "a middle group empty", "lengths 1", "one valid lane a group",
               "the one-block limit", "one past the one-block limit",
               "four groups", "int64 hi, negative lo",
               "int64 lo above 32 bits", "more tiles than the grid",
               *(f"lengths 1-300 #{i}" for i in range(6)))
#: K6's edge cases, each at both sides
SEARCH_EDGES = ("N = 0", "N = 1", "empty v", "v of two dimensions",
                "every key equal", "float32 NaN, -0.0, inf",
                "float64 NaN, -0.0, inf", "int64 extremes", "bool",
                "unsorted a", "int32 a, int64 v", "N = 2^20 + 1")
#: K7's bounded argsort (stable_argsort_bounded) at its edges
BOUNDED_EDGES = ("L = 1", "the one-block limit", "one past it",
                 "every lane invalid", "bound 0", "keys at 0 and the bound",
                 "app D's chunk")


def _packed_np(hi, lo):
    """The merge's int64 keys: hi << 32 | lo's low word (numpy wraps)."""
    return (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)


def _sorted_pairs(rng, n: int, hi=(0, 50), lo=(0, 4), hi_dt=np.int32,
                  lo_dt=np.int32):
    """(hi, lo) numpy words of n lanes drawn from [low, high) ranges and
    put in the order of their packed keys, so the keys are nondecreasing,
    as a window's groups hold them."""
    h = rng.integers(hi[0], hi[1], n).astype(hi_dt)
    lw = rng.integers(lo[0], lo[1], n).astype(lo_dt)
    order = np.argsort(_packed_np(h, lw), kind="stable")
    return h[order], lw[order]


def _merge_case(torch, dev, groups):
    """(hi, lo, valid) numpy triples -> the merge's (keys, valids)."""
    keys = [(torch.from_numpy(np.ascontiguousarray(h)).to(dev),
             torch.from_numpy(np.ascontiguousarray(lw)).to(dev))
            for h, lw, _ in groups]
    return keys, [torch.from_numpy(v).to(dev) for _, _, v in groups]


def merge_shapes(torch, rng, dev, B: int = BATCH, N: int = WINDOW) -> dict:
    """The K7 merge's inputs as the main path gives them: app D's sliding
    step (every arrival expires one row), app C's (a time window's
    triggers, half the candidates expiring), app A's lengthBatch(N) step
    after a partial flush (currents and RESETs) and the same with expired
    output (three groups)."""
    lane = np.arange(B, dtype=np.int32)
    every = np.ones(B, bool)
    trig = np.sort(rng.integers(0, B + 1, B)).astype(np.int32)
    r0, mf = N // 3, B // N + 2
    nf = (r0 + B) // N
    p = np.arange(B + N, dtype=np.int32)
    f = np.arange(mf, dtype=np.int32)
    exp_rel = p // N - 1
    cur = (np.clip((p // N + 1) * N - 1 - r0, -1, B).astype(np.int32) * 4
           + 2, p % N, p < nf * N)
    reset = (np.clip((f + 1) * N - 1 - r0, -1, B).astype(np.int32) * 4 + 1,
             np.zeros(mf, np.int32), f < nf)
    exp = (np.clip((exp_rel + 2) * N - 1 - r0, -1, B).astype(np.int32) * 4,
           p % N, exp_rel + 1 < nf)
    cases = {"app D's shape": [(lane * 4, lane, every),
                               (lane * 4 + 2, lane, every)],
             "app C's shape": [(trig * 4, lane, lane < B // 2 + 7000),
                               (lane * 4 + 2, lane, lane < int(0.9 * B))],
             "app A's shape": [cur, reset],
             "app A's shape, expired output": [cur, reset, exp]}
    return {k: _merge_case(torch, dev, g) for k, g in cases.items()}


def merge_edge_cases(torch, rng, dev) -> dict:
    """MERGE_EDGES: ties across groups, no valid lane, empty groups, the
    one-block limit and one past it, four groups, int64 words, a negative
    and a wide lo, more tiles than the cooperative grid holds, lengths
    1-300. Every group's valid keys are nondecreasing and below BIG, as
    `_merge_order` requires (outside that its order is undefined, in the
    JAX function as here)."""
    from siddhi_tpu_torch import kernels
    tile = kernels.bind("k7_merge", "k7_merge_tile_lanes", [])()
    cap = kernels.bind("k7_merge", "k7_merge_grid_capacity", [])()
    small = 4 * tile  # one block up to here

    def grp(n, p=0.6, **kw):
        h, lw = _sorted_pairs(rng, n, **kw)
        return h, lw, rng.random(n) < p

    one = dict(hi=(7, 8), lo=(3, 4))
    tie = dict(hi=(0, 5), lo=(0, 3))
    # int64 hi words: every packed key stays below BIG (the premise)
    wide = dict(hi=(-2**30, 2**30), lo=(-2**31, 2**31))
    big = dict(hi=(0, 1 << 20), lo=(0, 1 << 20))
    cases = {
        "ties across three groups": [grp(300, **tie), grp(257, **tie),
                                     grp(1, 1.0, **tie)],
        "every lane invalid": [grp(1000, 0.0), grp(3000, 0.0)],
        "every lane valid, one key": [grp(700, 1.0, **one),
                                      grp(900, 1.0, **one)],
        "first group empty": [grp(0), grp(500)],
        "a middle group empty": [grp(500), grp(0), grp(20, 1.0)],
        "lengths 1": [grp(1, 1.0), grp(1, 1.0)],
        "one valid lane a group": [grp(2000, 1 / 2000), grp(3000, 1 / 3000)],
        "the one-block limit": [grp(small // 2), grp(small - small // 2)],
        "one past the one-block limit": [grp(small // 2),
                                         grp(small // 2 + 1)],
        "four groups": [grp(100), grp(3000), grp(5), grp(7000)],
        "int64 hi, negative lo": [grp(3000, hi_dt=np.int64, **wide),
                                  grp(5000, **wide)],
        "int64 lo above 32 bits": [grp(2000, lo=(-2**40, 2**40),
                                       lo_dt=np.int64), grp(2000)],
        "more tiles than the grid": [grp((cap // 2 + 3) * tile, **big),
                                     grp((cap // 2 + 1) * tile + 9, 0.95,
                                         **big)],
    }
    for i in range(6):
        lens = rng.integers(1, 301, 2 + i % 2)
        cases[f"lengths 1-300 #{i}"] = [grp(int(n), rng.random(), **tie)
                                        for n in lens]
    return {k: _merge_case(torch, dev, g) for k, g in cases.items()}


def search_shapes(torch, rng, dev, B: int = BATCH) -> dict:
    """K6 as the main path calls it: app C's expiry trigger (each
    candidate's deadline into the batch's timestamps, invalid lanes at
    BIG) and app M's bucket trigger (timeBatch(1 sec), int32 buckets, the
    tail at INT32_MAX); name -> (a, v, side)."""
    lane = np.arange(B)
    n_valid = int(0.9 * B)
    ts = 1_700_000_000_000 + lane
    a = np.where(lane < n_valid, ts, BIG_KEY)
    cand = ts[0] - TIME_WINDOW_MS + np.sort(rng.integers(
        0, TIME_WINDOW_MS + B, B))
    buckets = np.where(lane < n_valid, lane // 1000, INT32_MAX)
    pending = (lane - 500) // 1000 + 1
    return {"app C's trigger": (torch.from_numpy(a).to(dev),
                                torch.from_numpy(cand + TIME_WINDOW_MS)
                                .to(dev), "left"),
            "app M's bucket trigger": (
                torch.from_numpy(buckets.astype(np.int32)).to(dev),
                torch.from_numpy(pending.astype(np.int32)).to(dev), "left")}


def search_edge_cases(torch, rng, dev) -> dict:
    """SEARCH_EDGES at both sides: name -> (a, v, side)."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def floats(dt):
        x = rng.normal(0, 10, 300).astype(dt)
        x[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan, -0.0, 1.0]
        q = np.concatenate([x[:8], rng.normal(0, 10, 40).astype(dt)])
        return np.sort(x, kind="stable"), q  # NaN last

    i64 = np.iinfo(np.int64)
    ext = np.sort(np.concatenate([rng.integers(-2**62, 2**62, 500),
                                  [i64.min, i64.min, i64.max, i64.max]]))
    deep = np.sort(rng.integers(0, 1 << 40, (1 << 20) + 1))
    f32, q32 = floats(np.float32)
    f64, q64 = floats(np.float64)
    base = {
        "N = 0": (np.zeros(0, np.int64), rng.integers(-5, 5, 100)),
        "N = 1": (np.array([3], np.int64), np.arange(-1, 6)),
        "empty v": (np.arange(10, dtype=np.int32), np.zeros(0, np.int32)),
        "v of two dimensions": (np.sort(rng.integers(0, 100, 200))
                                .astype(np.int32),
                                rng.integers(-5, 105, (37, 5))
                                .astype(np.int32)),
        "every key equal": (np.full(5000, 9, np.int64),
                            np.array([8, 9, 10] * 100)),
        "float32 NaN, -0.0, inf": (f32, q32),
        "float64 NaN, -0.0, inf": (f64, q64),
        "int64 extremes": (ext, np.concatenate([ext[::7], [i64.min,
                                                           i64.max]])),
        "bool": (np.array([False] * 40 + [True] * 60),
                 np.array([False, True] * 9)),
        "unsorted a": (rng.integers(0, 1000, 777), rng.integers(0, 1000,
                                                                 300)),
        "int32 a, int64 v": (np.sort(rng.integers(-50, 50, 1000))
                             .astype(np.int32),
                             rng.integers(-2**40, 2**40, 300)),
        "N = 2^20 + 1": (deep, rng.integers(0, 1 << 40, 1 << 16)),
    }
    return {f"{k}, {side}": (t(a), t(v), side)
            for k, (a, v) in base.items() for side in ("left", "right")}


def bounded_sort_cases(torch, rng, dev, K: int = GROUP_CAP) -> dict:
    """BOUNDED_EDGES: slot keys in [0, K] with their bound, as K5's and
    K5b's sorts hand them to K7; name -> (keys int32, bound)."""
    from siddhi_tpu_torch import kernels
    small = kernels.bind("k7_radix_sort", "k7_small_max", [])()

    def slots(n, p=0.9):
        s = rng.integers(0, K, n)
        return np.where(rng.random(n) < p, s, K).astype(np.int32)

    cases = {"L = 1": (slots(1), K), "the one-block limit": (slots(small), K),
             "one past it": (slots(small + 1), K),
             "every lane invalid": (np.full(5000, K, np.int32), K),
             "bound 0": (np.zeros(3000, np.int32), 0),
             "keys at 0 and the bound": (rng.choice([0, K], 9000)
                                         .astype(np.int32), K),
             "app D's chunk": (slots(2 * BATCH), K)}
    return {k: (torch.from_numpy(v).to(dev), b)
            for k, (v, b) in cases.items()}


def merge_search_rows(torch, rng, width_a: int) -> dict:
    """Phase 6's rows of the K7 merge (apps D, C and A), K6 (apps C and M)
    and K7's bounded argsort at K5's slot sort (app A's chunk) and K5b's
    (app C's): each bit for bit against its plain version, timed beside
    its library call (the merge's: a stable `torch.sort` of the packed
    keys with invalid lanes at BIG, made beforehand)."""
    from siddhi_tpu_torch.ops import search
    from siddhi_tpu_torch.ops import windows as w
    dev = torch.device("cuda")
    res = {}
    for name, (keys, valids) in merge_shapes(torch, rng, dev).items():
        def fn(keys=keys, valids=valids):
            return w._merge_order(keys, valids)

        def plain(keys=keys, valids=valids):
            return w._merge_order_plain(keys, valids)

        check_equal(f"K7 merge {name}", fn(), plain())
        packed = torch.where(torch.cat(valids), torch.cat(
            [(h.long() << 32) | (lw.long() & 0xFFFFFFFF) for h, lw in keys]),
            BIG_KEY)
        lanes = packed.numel()
        row = "K7 merge" if name == "app D's shape" else f"K7 merge ({name})"
        res[row] = dict(
            _timed(torch, fn, plain,
                   library=lambda p=packed: torch.sort(p, stable=True)),
            # hi, lo and valid read, the order written
            bound_ms=bound_ms(lanes * (4 + 4 + 1 + 4)), max_abs_err=0,
            bound_by="bytes")
        print(f"{row}: {lanes} lanes in {len(keys)} groups: {res[row]}")
    for name, (a, v, side) in search_shapes(torch, rng, dev).items():
        def fn(a=a, v=v, side=side):
            return search.searchsorted32(a, v, side)

        def plain(a=a, v=v, side=side):
            return search.searchsorted32_plain(a, v, side)

        check_equal(f"K6 {name}", fn(), plain())
        row = "K6" if name == "app C's trigger" else f"K6 ({name})"
        res[row] = dict(
            _timed(torch, fn, plain, library=lambda a=a, v=v:
                   torch.searchsorted(a, v, out_int32=True)),
            bound_ms=bound_ms(a.numel() * a.element_size()
                              + v.numel() * (v.element_size() + 4)),
            max_abs_err=0, bound_by="bytes")
        print(f"{row}: {v.numel()} into {a.numel()} {a.dtype}: {res[row]}")
    for row, L in (("K7 K5 sort", width_a), ("K7 K5b sort", 2 * BATCH)):
        s = rng.integers(0, GROUP_CAP, L)
        k = torch.from_numpy(np.where(rng.random(L) < 0.9, s, GROUP_CAP)
                             .astype(np.int32)).to(dev)

        def fn(k=k, row=row):
            return search.stable_argsort_bounded(k, GROUP_CAP, counter=row)

        def plain(k=k):
            return search.stable_radix_argsort_plain(k, GROUP_CAP)

        check_equal(row, fn(), plain())
        res[row] = dict(
            _timed(torch, fn, plain,
                   library=lambda k=k: torch.sort(k, stable=True)),
            bound_ms=bound_ms(L * (4 + 4)), max_abs_err=0, bound_by="bytes")
        print(f"{row}: L={L} keys in [0, {GROUP_CAP}]: {res[row]}")
    torch.cuda.synchronize()
    return res


def merge_search_edge_phase(torch, rng) -> None:
    """Phase 36: the K7 merge, K6 and K7's bounded argsort at their edges
    (MERGE_EDGES, SEARCH_EDGES, BOUNDED_EDGES), bit for bit, one launch a
    call (none without a lane or a query), merges of several sizes
    alternating on one stream with the workspace left zero, and K5's and
    K5b's grouped calls each one K7 sort."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, search
    from siddhi_tpu_torch.ops import windows as w
    dev = torch.device("cuda")

    def launches(counter, want, name):
        if kernels.LAUNCHES[counter] != want:
            raise Failure(f"{name}: {kernels.LAUNCHES[counter]} launches of "
                          f"{counter}, {want} expected")

    mcases = merge_edge_cases(torch, rng, dev)
    order = list(MERGE_EDGES) + 3 * ["more tiles than the grid", "lengths 1",
                                     "one past the one-block limit",
                                     "every lane invalid", "four groups"]
    for name in order:
        keys, valids = mcases[name]
        total = sum(int(k[0].numel()) for k in keys)
        kernels.reset_launch_counts()
        got = w._merge_order(keys, valids)
        launches("K7 merge", 1 if total else 0, f"K7 merge edge {name}")
        check_equal(f"K7 merge edge {name}", got,
                    w._merge_order_plain(keys, valids))
    torch.cuda.synchronize()
    if int(kernels.workspace("k7_merge", 0, dev).count_nonzero()):
        raise Failure("K7 merge: the workspace is not zero after the edges")
    scases = search_edge_cases(torch, rng, dev)
    for name, (a, v, side) in scases.items():
        kernels.reset_launch_counts()
        got = search.searchsorted32(a, v, side)
        launches("K6", 1 if v.numel() else 0, f"K6 edge {name}")
        check_equal(f"K6 edge {name}", got,
                    search.searchsorted32_plain(a, v, side))
    bcases = bounded_sort_cases(torch, rng, dev)
    for name, (k, bound) in bcases.items():
        kernels.reset_launch_counts()
        got = search.stable_argsort_bounded(k, bound)
        launches("K7 bounded", 1, f"K7 bounded edge {name}")
        check_equal(f"K7 bounded edge {name}", got,
                    search.stable_radix_argsort_plain(k, bound))
    # K5's and K5b's grouped calls: one K7 sort each, no torch.sort
    k, _ = bcases["app D's chunk"]
    L = k.numel()
    slots = torch.where(k < GROUP_CAP, k, 0)
    valid = k < GROUP_CAP
    no_resets = torch.zeros(L, dtype=torch.bool, device=dev)
    cur = torch.zeros((), dtype=torch.int32, device=dev)
    d = torch.ones(L, dtype=torch.int64, device=dev)
    kernels.reset_launch_counts()
    groupby.grouped_scan_fused(
        [torch.zeros(GROUP_CAP, dtype=torch.int64, device=dev)],
        torch.zeros(GROUP_CAP, dtype=torch.int32, device=dev), slots, [d],
        valid, no_resets, cur)
    launches("K7 K5 sort", 1, "K5 grouped")
    launches("K5", 1, "K5 grouped")
    groupby.grouped_scan(groupby.init_group_state(GROUP_CAP, torch.int64,
                                                  dev),
                         slots, d, valid, no_resets, cur)
    launches("K7 K5b sort", 1, "K5b grouped")
    launches("K5b grouped", 1, "K5b grouped")
    torch.cuda.synchronize()
    print(f"K7 merge edges ({len(mcases)}), K6 edges ({len(scases)}), K7 "
          f"bounded edges ({len(bcases)}): bit for bit, one launch a call; "
          "K5 and K5b one K7 sort a call")


def sliding_kernel_phase(torch, rng, mrng, width_a: int
                         ) -> tuple[dict, dict]:
    """K2b and K5b against their plain versions at the sliding apps'
    shapes; the K7 merge, K6 and K7's bounded argsort at theirs (inputs
    from `mrng`, so that `rng` leaves the later phases as before); then
    the torch route K2a timed at its shapes. Returns (kernel results,
    torch-route results)."""
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.ops import groupby, search
    from siddhi_tpu_torch.ops import windows as w

    dev = torch.device("cuda")
    res, routes = {}, {}
    B = E = C = BATCH
    layout = {"symbol": torch.int32, "price": torch.float32,
              "volume": torch.int64}
    W = w._layout_words(layout)  # 6 words for TradeStream
    cols = {"symbol": torch.from_numpy(rng.integers(1, C_SYMBOLS, B).astype(
                np.int32)).to(dev),
            "price": torch.from_numpy(rng.uniform(1, 100, B).astype(
                np.float32)).to(dev),
            "volume": torch.from_numpy(rng.integers(1, 1000, B)).to(dev)}
    ts = torch.arange(B, dtype=torch.int64, device=dev) + 1_700_000_000_000
    live = torch.from_numpy(rng.random(B) < 0.9).to(dev)
    order = search.stable_partition_order(live)
    n_live = int(live.sum())

    # pack-compact: read the typed columns, ts and K1's order, write [W, B]
    got = w.pack_compact(cols, ts, layout, order)
    check_equal("K2b pack", got, w.pack_compact_plain(cols, ts, layout,
                                                      order))
    res["K2b pack"] = dict(
        _timed(torch, lambda: w.pack_compact(cols, ts, layout, order),
               lambda: w.pack_compact_plain(cols, ts, layout, order)),
        bound_ms=bound_ms(B * (4 + 4 + 8 + 8 + 4) + W * 4 * B),
        max_abs_err=0, bound_by="bytes")
    comp = got

    # fetch at app C's steady state: the window holds 60000 rows of the
    # ring; the other candidates come from the batch (rel0 = 60000)
    ring0 = torch.from_numpy(rng.integers(-(2**31), 2**31, (W, C)).astype(
        np.int32)).to(dev)
    expired = torch.tensor(1_000_000, device=dev)
    appended = torch.tensor(1_000_000 + TIME_WINDOW_MS, device=dev)
    # the append lands across the ring's end: 1,120,000 % C + n_live > C
    append_at = torch.tensor(1_000_000 + 120_000, device=dev)
    if int(append_at) % C + n_live <= C:
        raise Failure("K2b append: the test position does not wrap")
    n_valid = torch.tensor(n_live, dtype=torch.int32, device=dev)
    check_equal("K2b fetch", w._fetch_rel_packed(ring0, comp, expired,
                                                 appended, E),
                w._fetch_rel_packed_plain(ring0, comp, expired, appended, E))
    ring_idx = torch.remainder(expired + torch.arange(E, device=dev), C)
    res["K2b fetch"] = dict(
        _timed(torch,
               lambda: w._fetch_rel_packed(ring0, comp, expired, appended,
                                           E),
               lambda: w._fetch_rel_packed_plain(ring0, comp, expired,
                                                 appended, E),
               library=lambda: ring0[:, ring_idx]),
        bound_ms=bound_ms(2 * W * 4 * E), max_abs_err=0, bound_by="bytes")

    # append at a wrapping position
    ring = ring0.clone()
    want = w._append_packed_plain(ring0, comp, append_at, n_valid)
    check_equal("K2b append", w._append_packed(ring, comp, append_at,
                                               n_valid), want)
    dest = torch.remainder(append_at + torch.arange(n_live, device=dev), C)
    comp_v = comp[:, :n_live].contiguous()

    def lib_append():
        ring[:, dest] = comp_v

    res["K2b append"] = dict(
        _timed(torch,
               lambda: w._append_packed(ring, comp, append_at, n_valid),
               lambda: w._append_packed_plain(ring, comp, append_at,
                                              n_valid),
               library=lib_append),
        bound_ms=bound_ms(2 * W * 4 * n_live), max_abs_err=0,
        bound_by="bytes")

    # chunk gather over E + B lanes by a permutation (random: no locality)
    L = E + B
    payload = torch.cat([ring0, comp], dim=1)
    perm = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    emit = torch.arange(L, dtype=torch.int64, device=dev)
    valid = torch.from_numpy(rng.random(L) < 0.5).to(dev)
    types = torch.from_numpy(rng.integers(0, 2, L).astype(np.int8)).to(dev)
    args = (perm, payload, emit, valid, types, layout)
    kb = w._gather_chunk_packed(*args)
    pb = w._gather_chunk_packed_plain(*args)
    for nm in ("ts", "valid", "types"):
        check_equal(f"K2b gather {nm}", getattr(kb, nm), getattr(pb, nm))
    for k in layout:
        check_equal(f"K2b gather {k}", kb.cols[k], pb.cols[k])
    perm64 = perm.long()
    res["K2b gather"] = dict(
        _timed(torch, lambda: w._gather_chunk_packed(*args),
               lambda: w._gather_chunk_packed_plain(*args),
               library=lambda: torch.index_select(payload, 1, perm64)),
        # order, the column words, emit ts, valid, type in; typed columns,
        # ts, valid, type out
        bound_ms=bound_ms(L * (4 + (W - 2) * 4 + 8 + 1 + 1)
                          + L * (4 + 4 + 8 + 8 + 1 + 1)),
        max_abs_err=0, bound_by="bytes")
    # the same gather on the order a sliding step gives it: app D's
    # steady state, where every arrival expires one row, so _merge_order
    # interleaves the E expired candidates (pe order) and the B arrivals
    lane = torch.arange(B, dtype=torch.int32, device=dev)
    every = torch.ones(B, dtype=torch.bool, device=dev)
    merge = w._merge_order([(lane * 4 + w.KIND_EXPIRED, lane),
                            (lane * 4 + w.KIND_CURRENT, lane)],
                           [every, every])
    margs = (merge, payload, emit, valid, types, layout)
    kb = w._gather_chunk_packed(*margs)
    pb = w._gather_chunk_packed_plain(*margs)
    for nm in ("ts", "valid", "types"):
        check_equal(f"K2b gather merge order {nm}", getattr(kb, nm),
                    getattr(pb, nm))
    for k in layout:
        check_equal(f"K2b gather merge order {k}", kb.cols[k], pb.cols[k])
    merge64 = merge.long()
    res["K2b gather (app D's merge order)"] = dict(
        _timed(torch, lambda: w._gather_chunk_packed(*margs),
               lambda: w._gather_chunk_packed_plain(*margs),
               library=lambda: torch.index_select(payload, 1, merge64)),
        bound_ms=res["K2b gather"]["bound_ms"], max_abs_err=0,
        bound_by="bytes")
    for k in ("K2b pack", "K2b fetch", "K2b append", "K2b gather",
              "K2b gather (app D's merge order)"):
        print(f"{k} B=E=C={B} W={W}: {res[k]}")

    # K5b at the chunk width of the sliding apps, K = 2^20
    L, K = 2 * BATCH, GROUP_CAP
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(L) < 0.9).to(dev)
    resets = torch.zeros(L, dtype=torch.bool, device=dev)
    resets[torch.from_numpy(rng.choice(L, 3, replace=False)).to(dev)] = True
    valid &= ~resets
    no_resets = torch.zeros(L, dtype=torch.bool, device=dev)
    cur = torch.tensor(5, dtype=torch.int32, device=dev)
    deltas = {torch.int64: torch.from_numpy(rng.choice([-1, 1], L)).to(dev),
              torch.float32: torch.from_numpy(rng.uniform(
                  -100, 100, L).astype(np.float32)).to(dev)}
    epochs0 = torch.from_numpy(rng.integers(3, 7, K).astype(np.int32)).to(dev)
    grouped, ungrouped = {}, {}
    for dt, d in deltas.items():
        values0 = torch.from_numpy(rng.integers(0, 50, K)).to(dev).to(dt)
        for op in ("sum", "min", "max"):
            st = groupby.GroupState(values0.clone(), epochs0.clone())

            def restore(st=st, v0=values0):
                st.values.copy_(v0)
                st.epoch.copy_(epochs0)

            ps, po = groupby.grouped_scan_plain(
                groupby.GroupState(values0.clone(), epochs0.clone()), slots,
                d, valid, resets, cur, op)
            ks, ko = groupby.grouped_scan(st, slots, d, valid, resets, cur,
                                          op)
            check_equal(f"K5b grouped {op} {dt} epoch", ks.epoch, ps.epoch)
            err = 0.0
            for a, b in ((ks.values, ps.values), (ko, po)):
                if dt == torch.int64 or op != "sum":
                    check_equal(f"K5b grouped {op} {dt}", a, b)
                else:
                    err = max(err, check_float_scan(
                        f"K5b grouped {op} {dt}", a, b))
            grouped[(op, dt)] = dict(_timed(
                torch,
                lambda st=st, d=d, op=op: groupby.grouped_scan(
                    st, slots, d, valid, resets, cur, op),
                lambda st=st, d=d, op=op: groupby.grouped_scan_plain(
                    st, slots, d, valid, resets, cur, op),
                reset=restore), max_abs_err=err)
        for rs_name, rs in (("resets", resets), ("no resets", no_resets)):
            for op in ("sum", "max"):
                cell0 = values0[:1].clone()
                ep0 = torch.tensor([5], dtype=torch.int32, device=dev)
                st = groupby.GroupState(cell0.clone(), ep0.clone())

                def restore(st=st, c0=cell0, e0=ep0):
                    st.values.copy_(c0)
                    st.epoch.copy_(e0)

                ps, po = groupby.ungrouped_scan_plain(
                    groupby.GroupState(cell0.clone(), ep0.clone()), d, valid,
                    rs, cur, op)
                ks, ko = groupby.ungrouped_scan(st, d, valid, rs, cur, op)
                check_equal(f"K5b ungrouped {op} {rs_name} epoch", ks.epoch,
                            ps.epoch)
                err = 0.0
                for a, b in ((ks.values, ps.values), (ko, po)):
                    if dt == torch.int64 or op != "sum":
                        check_equal(f"K5b ungrouped {op} {dt} {rs_name}", a,
                                    b)
                    else:
                        err = max(err, check_float_scan(
                            f"K5b ungrouped {op} {dt} {rs_name}", a, b))
                lib = (lambda d=d: torch.cumsum(d, 0)) \
                    if (op == "sum" and rs is no_resets) else None
                ungrouped[(op, dt, rs_name)] = dict(_timed(
                    torch,
                    lambda st=st, d=d, rs=rs, op=op: groupby.ungrouped_scan(
                        st, d, valid, rs, cur, op),
                    lambda st=st, d=d, rs=rs, op=op:
                        groupby.ungrouped_scan_plain(st, d, valid, rs, cur,
                                                     op),
                    library=lib, reset=restore), max_abs_err=err)
    for (op, dt), r in grouped.items():
        print(f"K5b grouped_scan op={op} {dt} L={L} K={K}: {r}")
    for (op, dt, rs), r in ungrouped.items():
        print(f"K5b ungrouped_scan op={op} {dt} {rs} L={L}: {r}")
    # the path's instantiations: int64 sums (distinctCount's counts)
    touched = int(torch.unique(torch.where(valid, slots, -1)).numel()) - 1
    res["K5b grouped"] = dict(
        grouped[("sum", torch.int64)], bound_by="bytes",
        # slots, valid, resets, deltas in, outputs out; per touched slot
        # one value and one epoch read and written
        bound_ms=bound_ms(L * (4 + 1 + 1 + 8 + 8) + touched * (8 + 8 + 8)))
    res["K5b ungrouped"] = dict(
        ungrouped[("sum", torch.int64, "no resets")], bound_by="bytes",
        bound_ms=bound_ms(L * (1 + 1 + 8 + 8)))
    res["K5b ungrouped"]["max_abs_err"] = max(
        r["max_abs_err"] for r in ungrouped.values())
    res["K5b grouped"]["max_abs_err"] = max(
        r["max_abs_err"] for r in grouped.values())

    # K5 without GROUP BY at the same width: app F's three components
    # (float32 sum, int64 sum, int64 count) over one plan, no sort
    comps = [deltas[torch.float32], deltas[torch.int64] * 7,
             deltas[torch.int64]]
    cells0 = [torch.tensor([v], dtype=c.dtype, device=dev)
              for v, c in zip((1234.5, 999, 40), comps)]
    ep_cell0 = torch.tensor([5], dtype=torch.int32, device=dev)
    u_vals = [c.clone() for c in cells0]
    u_ep = ep_cell0.clone()

    def restore_u():
        for v, v0 in zip(u_vals, cells0):
            v.copy_(v0)
        u_ep.copy_(ep_cell0)

    err = 0.0
    for rs_name, rs in (("resets", resets), ("no resets", no_resets)):
        restore_u()
        kv, ke, ko = groupby.ungrouped_scan_fused(u_vals, u_ep, comps, valid,
                                                  rs, cur)
        pv, pe, po = groupby.ungrouped_scan_fused_plain(
            [v.clone() for v in cells0], ep_cell0.clone(), comps, valid, rs,
            cur)
        check_equal(f"K5 ungrouped {rs_name} epoch", ke, pe)
        for c in range(len(comps)):
            for a, b in ((kv[c], pv[c]), (ko[c], po[c])):
                if a.dtype == torch.int64:
                    check_equal(f"K5 ungrouped {rs_name} component {c}", a,
                                b)
                else:
                    err = max(err, check_float_scan(
                        f"K5 ungrouped {rs_name} component {c}", a, b))
    res["K5 ungrouped"] = dict(
        _timed(torch,
               lambda: groupby.ungrouped_scan_fused(u_vals, u_ep, comps,
                                                    valid, no_resets, cur),
               lambda: groupby.ungrouped_scan_fused_plain(
                   u_vals, u_ep, comps, valid, no_resets, cur),
               library=lambda: [torch.cumsum(c, 0) for c in comps],
               reset=restore_u),
        # valid and resets in; per component the deltas in, outputs out
        bound_ms=bound_ms(L * (1 + 1) + sum(2 * L * c.element_size()
                                            for c in comps)),
        max_abs_err=err, bound_by="bytes")
    print(f"K5 ungrouped_scan_fused L={L} comps={len(comps)}: "
          f"{res['K5 ungrouped']}")

    # torch routes: K2a ring ops at app A's shapes
    N = WINDOW
    Ca = 2 * N + BATCH
    ring_cols = {k: torch.zeros(Ca + 1, dtype=v.dtype, device=dev)
                 for k, v in cols.items()}
    ring_ts = torch.zeros(Ca + 1, dtype=torch.int64, device=dev)
    offs = torch.arange(BATCH + N, dtype=torch.int32, device=dev)
    base = torch.tensor(5 * N, device=dev)
    app0 = torch.tensor(5 * N + 3 * N // 2, device=dev)
    nv = torch.tensor(BATCH, dtype=torch.int32, device=dev)
    row = 4 + 4 + 8 + 8  # symbol, price, volume, ts
    routes["K2a _gather_rel"] = dict(
        ms=device_ms(torch, lambda: w._gather_rel(
            ring_cols, ring_ts, cols, ts, app0, base, offs)),
        bound_ms=bound_ms(2 * (BATCH + N) * row), shape=f"L={BATCH + N}")
    routes["K2a _scatter_append"] = dict(
        ms=device_ms(torch, lambda: w._scatter_append(
            ring_cols, ring_ts, cols, ts, app0, nv)),
        bound_ms=bound_ms(2 * BATCH * row), shape=f"B={BATCH} C={Ca}")
    for k, r in routes.items():
        print(f"{k}: {r}")
    torch.cuda.synchronize()
    res.update(merge_search_rows(torch, mrng, width_a))
    return res, routes


# --------------------------------------------------------------------------- #
# phases 3-5: the apps and the oracle
# --------------------------------------------------------------------------- #


def make_events(rng, keyed_by_long: bool):
    n = BATCH * ROUNDS
    idx = rng.integers(0, N_KEYS, n)
    if keyed_by_long:
        ids = rng.choice(2**63 - 1, N_KEYS, replace=False).astype(np.int64)
        key = ids[idx]
    else:
        key = idx + 1  # symbol "S<k>", k in 1..1000000
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return key, price, volume, ts


def oracle(key, price32, ts, passed):
    """Running per-key sum/count inside each completed flush of WINDOW
    passing events, in arrival order (float64)."""
    sel = np.nonzero(passed)[0]
    n_full = (sel.shape[0] // WINDOW) * WINDOW
    sel = sel[:n_full]
    k, v = key[sel], price32[sel].astype(np.float64)
    total = np.empty(n_full)
    cnt = np.empty(n_full)
    for f in range(0, n_full, WINDOW):
        kk, vv = k[f:f + WINDOW], v[f:f + WINDOW]
        order = np.argsort(kk, kind="stable")
        ks, vs = kk[order], vv[order]
        start = np.r_[True, ks[1:] != ks[:-1]]
        seg = np.cumsum(start) - 1
        cs = np.cumsum(vs)
        base = (cs - vs)[start][seg]
        run = cs - base
        pos = np.arange(WINDOW)
        c = pos - pos[start][seg] + 1
        total[f + order] = run
        cnt[f + order] = c
    return sel, total, total / cnt, ts[sel]


K4_SITES = (("siddhi_tpu_torch.ops.selector", "key_lookup_or_insert"),
            ("siddhi_tpu_torch.ops.aggregators", "key_lookup_or_insert"),
            ("siddhi_tpu_torch.core.aggregation", "key_lookup_or_insert"))
K10_SITES = (("siddhi_tpu_torch.core.join_runtime", "multimap_append"),)


@contextlib.contextmanager
def counting_calls(sites):
    """Counts the calls with lanes (a non-empty second argument) of the
    wrappers bound at `sites` ((module, name) pairs) while the block runs;
    yields a dict of the count under "calls"."""
    import importlib
    count = {"calls": 0}
    saved = []
    for mod_name, name in sites:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, **kw):
            if a[1].shape[0]:
                count["calls"] += 1
            return _fn(*a, **kw)

        setattr(mod, name, wrapped)
    try:
        yield count
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_one_launch_a_call(app, launches, counter, calls) -> None:
    """The app's launches of `counter` against its wrapper's calls with
    lanes: one a call."""
    if launches[counter] != calls:
        raise Failure(f"app {app}: {launches[counter]} {counter} launches "
                      f"for {calls} calls, one a call expected")
    print(f"app {app}: {counter} {calls} calls, {launches[counter]} "
          "launches (one a call)")


def run_app(torch, text: str, columns: dict, ts,
            out_stream: str = "SummaryStream", rounds: int = ROUNDS,
            batch: int = BATCH, after_round=None):
    """Feed `rounds` sends of `batch` events (send_columns + flush each)
    and collect the output stream's events (a tuple of streams: a dict of
    each one's events). `after_round(rt, r)` runs after each round's
    flush, inside the timed run (heartbeats)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch import kernels

    rt = SiddhiManager().create_siddhi_app_runtime(
        text, batch_size=batch, group_capacity=GROUP_CAP)
    outs = (out_stream,) if isinstance(out_stream, str) else out_stream
    streams = {o: [] for o in outs}
    for o in outs:
        rt.add_callback(o, streams[o].extend)
    got = streams[out_stream] if isinstance(out_stream, str) else streams
    h = rt.get_input_handler("TradeStream")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        h.send_columns({k: v[s] for k, v in columns.items()},
                       timestamps=ts[s])
        rt.flush()
        if after_round is not None:
            after_round(rt, r)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return rt, got, launches, elapsed, peak


def check_app(name, got, key_col, key, price, ts, passed, long_key):
    price32 = price.astype(np.float32)
    sel, total, avg, ots = oracle(key, price32, ts, passed)
    if len(got) != sel.shape[0]:
        raise Failure(f"app {name}: {len(got)} events out, oracle expects "
                      f"{sel.shape[0]}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, len(got))
    if not np.array_equal(g_ts, ots):
        raise Failure(f"app {name}: timestamps differ from the oracle")
    g_key = [e.data[0] for e in got]
    exp_key = key[sel].tolist() if long_key else key_col[sel].tolist()
    if g_key != exp_key:
        raise Failure(f"app {name}: group keys differ from the oracle")
    g_tot = np.fromiter((e.data[1] for e in got), np.float64, len(got))
    g_avg = np.fromiter((e.data[2] for e in got), np.float64, len(got))
    for what, g, o in (("total", g_tot, total), ("avgPrice", g_avg, avg)):
        if not np.allclose(g, o, rtol=RTOL, atol=0):
            bad = np.max(np.abs(g - o) / np.abs(o))
            raise Failure(f"app {name}: {what} off by rel {bad:.3g}")
    return len(got)


# ---- the sliding apps' data and oracles ------------------------------------


def symbols(n_pool: int) -> np.ndarray:
    return np.array([f"S{k}" for k in range(1, n_pool + 1)], dtype=object)


def sliding_events(rng, n_symbols: int):
    """symbol index uniform over n_symbols, price 1-100, volume 1-999,
    timestamps 1 ms apart."""
    n = BATCH * ROUNDS
    sym = rng.integers(0, n_symbols, n)
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return sym, price, volume, ts


def next_same(key: np.ndarray) -> np.ndarray:
    """Index of the next event with the same key (n where there is none)."""
    n = key.shape[0]
    order = np.argsort(key, kind="stable")
    nxt = np.full(n, n, dtype=np.int64)
    same = key[order[1:]] == key[order[:-1]]
    nxt[order[:-1][same]] = order[1:][same]
    return nxt


def distinct_in_window(key: np.ndarray, span: int) -> np.ndarray:
    """Per event i, the distinct keys among events [i - span + 1, i]: event
    j counts for i in [j, min(next_same(j), j + span)) as its key's last
    occurrence in the window."""
    n = key.shape[0]
    end = np.minimum(next_same(key), np.arange(n) + span)
    diff = (np.bincount(np.arange(n), minlength=n + 1)
            - np.bincount(end, minlength=n + 1))
    return np.cumsum(diff)[:n]


def oracle_c(sym: np.ndarray) -> np.ndarray:
    return distinct_in_window(sym, TIME_WINDOW_MS)


def oracle_d(sym: np.ndarray, price32: np.ndarray):
    """Per event, the running sum and count of its symbol over the last
    LENGTH_D events, inclusive (float64)."""
    n = sym.shape[0]
    idx = np.arange(n, dtype=np.int64)
    order = np.lexsort((idx, sym))
    ks = sym[order].astype(np.int64)
    comb = ks * n + idx[order]
    cs = np.cumsum(price32[order].astype(np.float64))
    lo = np.maximum(np.searchsorted(comb, comb - LENGTH_D, side="right"),
                    np.searchsorted(comb, ks * n, side="left"))
    q = np.arange(n)
    total = cs - np.where(lo > 0, cs[np.maximum(lo - 1, 0)], 0.0)
    count = q - lo + 1
    out_t = np.empty(n)
    out_c = np.empty(n, dtype=np.int64)
    out_t[order] = total
    out_c[order] = count
    return out_t, out_c


def oracle_f(price32: np.ndarray, volume: np.ndarray):
    """Per event, the sum of price (float64), the sum of volume and the
    count over the last LENGTH_D events, inclusive."""
    n = price32.shape[0]
    lo = np.maximum(np.arange(n) - LENGTH_D, -1)

    def window_sum(x):
        cs = np.concatenate([[0], np.cumsum(x)])
        return cs[1:] - cs[lo + 1]

    return (window_sum(price32.astype(np.float64)), window_sum(volume),
            np.arange(n) - lo)


def oracle_e(sym: np.ndarray, volume: np.ndarray) -> np.ndarray:
    """Per event, the distinct volumes of its symbol among the events of
    the last TIME_WINDOW_MS ms: pair (symbol, volume) j counts for the
    symbol's events in [j, min(next pair j, j + span)), counted along the
    symbol's own event list."""
    n = sym.shape[0]
    idx = np.arange(n, dtype=np.int64)
    pair = sym.astype(np.int64) * 1000 + volume
    end = np.minimum(next_same(pair), idx + TIME_WINDOW_MS)
    order = np.lexsort((idx, sym))
    comb = sym[order].astype(np.int64) * n + idx[order]
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    end_pos = np.searchsorted(comb, sym.astype(np.int64) * n + end,
                              side="left")
    # a -1 landing on the next symbol's first position cancels against the
    # surplus of this symbol's open intervals, so one global cumsum serves
    diff = (np.bincount(pos, minlength=n + 1)
            - np.bincount(end_pos, minlength=n + 1))
    out = np.empty(n, dtype=np.int64)
    out[order] = np.cumsum(diff)[:n]
    return out


def check_sliding(name: str, got, ts, expect_cols: list) -> int:
    """Every output event against the oracle: timestamps and the columns
    in `expect_cols` ((what, values, float?)), in arrival order. float?
    is True for sums (rtol and atol), "exact" for floats the oracle holds
    exactly (stored float32 values), False for integers."""
    n = ts.shape[0]
    if len(got) != n:
        raise Failure(f"app {name}: {len(got)} events out, expected {n}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, n)
    if not np.array_equal(g_ts, ts):
        raise Failure(f"app {name}: timestamps differ from the oracle")
    for i, (what, want, is_float) in enumerate(expect_cols):
        if isinstance(want, list):
            if [e.data[i] for e in got] != want:
                raise Failure(f"app {name}: {what} differs from the oracle")
            continue
        g = np.fromiter((e.data[i] for e in got),
                        np.float64 if is_float else np.int64, n)
        if is_float is True:
            ok = np.isclose(g, want, rtol=RTOL, atol=ATOL_SLIDING)
        else:
            ok = g == want
        if not ok.all():
            j = int(np.argmin(ok))
            raise Failure(f"app {name}: {what} of event {j} is {g[j]}, the "
                          f"oracle says {want[j]}")
    return n


def call_watching_syncs(torch, fn):
    """(fn(), where it synced with the host under
    torch.cuda.set_sync_debug_mode('warn')): one "file:line" per
    synchronizing call, with the port's own frame that made it."""
    syncs = []

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()
                    if "siddhi_tpu_torch" in f.filename]
            site = f"{filename.rsplit('/', 1)[-1]}:{lineno}"
            if ours:
                site += (f" from {ours[-1].filename.rsplit('/', 1)[-1]}:"
                         f"{ours[-1].lineno}")
            syncs.append(site)

    # switch the mode once outside the capture: the first switch in a
    # process syncs by itself
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, syncs


def syncs_in(torch, fn) -> list:
    """Where fn() syncs with the host (call_watching_syncs), starting from
    an idle card."""
    torch.cuda.synchronize()
    return call_watching_syncs(torch, fn)[1]


def measure_steps(torch, rt, columns: dict, ts, fresh: bool = False,
                  rounds: int = ROUNDS, batch: int = BATCH,
                  window: str = None, query: str = "bench"):
    """The query step alone (no ingest, no output decode) over the app's
    rounds, as device batches prepared beforehand, each at its round's
    event time. `fresh` restarts from the query's initial state, so a
    sliding window sees the same traffic as in the app run; with a named
    `window` feeding the query, a step is the window's step and then the
    query's (`query` names the query). Returns (where one step syncs with
    the host under torch.cuda.set_sync_debug_mode('warn'), one "file:line"
    per synchronizing call; mean ms per step)."""
    from siddhi_tpu_torch.core.event import EventBatch

    qr = rt.query_runtimes[query]
    w = rt.windows[window] if window is not None else None
    j = rt.junctions["TradeStream"]
    batches, nows = [], []
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        cols = j.codec.encode_columns({k: v[s] for k, v in columns.items()},
                                      batch)
        batches.append(EventBatch.from_numpy(ts[s], cols, batch,
                                             j.ctx.device))
        nows.append(int(ts[s].max()))
    dev = j.ctx.device

    def restart():
        qr.state = (qr.window.init_state(dev), qr.selector.init_state(dev),
                    qr.rate_limiter.init_state(dev))
        if w is not None:
            w.state = w.window.init_state(dev)

    def step(b, now):
        if w is not None:
            w.state, chunk = w.window.step(w.state, b, now)
            b = w._apply_output_event_type(chunk)
        qr.state, _ = qr.step(qr.state, b, now)

    if fresh:
        restart()
    syncs = syncs_in(torch, lambda: step(batches[0], nows[0]))
    if fresh:
        restart()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, now in zip(batches, nows):
        step(b, now)
    torch.cuda.synchronize()
    return syncs, (time.perf_counter() - t0) / rounds * 1e3


def report_app(name, n_in, n_out, elapsed, step_ms, peak, launches, syncs,
               card, rounds=ROUNDS, batch=BATCH) -> None:
    print(f"app {name}: {n_in} events in, {n_out} out, matches the oracle; "
          f"{n_in / elapsed:.1f} events/s end to end "
          f"({elapsed * 1e3 / rounds:.3f} ms per {batch}-event round); "
          f"query step alone {step_ms:.3f} ms per round; peak device memory "
          f"{peak / 2**20:.1f} MiB; kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }; host syncs in one "
          f"step: {len(syncs)} {syncs} [{card}]")


def sliding_apps(torch, rng, card: str, summary=None) -> dict:
    """Apps C, D, E and F against their oracles; C and D also through the
    columnar async path when `summary` is given; returns their
    launches."""
    k2b = ("K2b pack", "K2b fetch", "K2b append", "K2b gather")
    on_path = {"C": ("K1", *k2b, "K5b grouped", "K5b ungrouped", "K6",
                     "K7 merge", "K7 K5b sort"),
               "D": ("K1", *k2b, "K5", "K7 merge", "K7 K5 sort"),
               "E": ("K1", *k2b, "K3", "K4", "K5b grouped", "K6",
                     "K7 merge", "K7 K5b sort"),
               "F": ("K1", *k2b, "K5 ungrouped", "K7 merge")}
    total = {}
    for name, text, n_sym in (("C", APP_C, C_SYMBOLS),
                              ("D", APP_D, N_KEYS),
                              ("E", APP_E, E_SYMBOLS),
                              ("F", APP_F, E_SYMBOLS)):
        sym, price, volume, ts = sliding_events(rng, n_sym)
        pool = symbols(n_sym)
        columns = {"symbol": pool[sym], "price": price, "volume": volume}
        with counting_calls(K4_SITES) as k4:
            rt, got, launches, elapsed, peak = run_app(
                torch, text, columns, ts, out_stream="OutStream")
        if name == "E":
            check_one_launch_a_call("E", launches, "K4", k4["calls"])
        if name == "C":
            expect = [("distinctSymbols", oracle_c(sym), False)]
        elif name == "D":
            total_d, count_d = oracle_d(sym, price.astype(np.float32))
            expect = [("symbol", columns["symbol"].tolist(), False),
                      ("total", total_d, True), ("n", count_d, False)]
        elif name == "E":
            expect = [("symbol", columns["symbol"].tolist(), False),
                      ("n", oracle_e(sym, volume), False)]
        else:
            total_f, vol_f, count_f = oracle_f(price.astype(np.float32),
                                               volume)
            expect = [("total", total_f, True), ("vol", vol_f, False),
                      ("n", count_f, False)]
        n_out = check_sliding(name, got, ts, expect)
        del got
        for k in on_path[name] + ("K12a",):
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        syncs, step_ms = measure_steps(torch, rt, columns, ts, fresh=True)
        report_app(name, ts.shape[0], n_out, elapsed, step_ms, peak,
                   launches, syncs, card)
        del rt
        if summary is not None and name in ("C", "D"):
            col = columnar_pair(
                torch, name, text, round_sends("TradeStream", columns, ts),
                "OutStream", BATCH, ROUNDS,
                lambda g, e=expect, n=name: check_sliding(n, g, ts, e),
                elapsed, card, summary, gcap=GROUP_CAP)
            for k, v in col.items():
                total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------- #
# phases 8-9: the join kernels and app G
# --------------------------------------------------------------------------- #


def _check_state(name, a, b) -> None:
    for f, x, y in zip(a._fields, a, b):
        check_equal(f"{name} {f}", x, y)


def _build_multimap(torch, rng, start: int, n_batches: int):
    """A K10 multimap over a LENGTH_G ring after n_batches app-G batches
    (97% live) from overall index `start`, by the kernel and by the plain
    version, checked bit for bit after every batch. Returns (state, its
    plain twin, next overall index, the last batch's inputs)."""
    from siddhi_tpu_torch.ops import groupby, join

    dev = torch.device("cuda")
    kmm = join.multimap_init(LENGTH_G, BUCKETS_G, dev)
    pmm = join.multimap_init(LENGTH_G, BUCKETS_G, dev)
    appended = start
    for i in range(n_batches):
        keys = torch.from_numpy(rng.integers(1, LENGTH_G + 1, BATCH_G).astype(
            np.int32)).to(dev)
        hashes = groupby.hash_columns32_plain([keys], remap=True)
        live = torch.from_numpy(rng.random(BATCH_G) < 0.97).to(dev)
        a0 = torch.tensor(appended, device=dev)
        if i == n_batches - 1:
            last = (hashes, live, a0, [t.clone() for t in kmm])
        kmm = join.multimap_append(kmm, hashes, live, a0)
        pmm = join.multimap_append_plain(pmm, hashes, live, a0)
        _check_state(f"K10 append (batch {i})", kmm, pmm)
        appended += int(live.sum())
    return kmm, pmm, appended, last


def _probe_walk(torch, mm, hashes, valid, appended, wlen, k_max):
    """(chain entries a probe reads, lanes) for the byte bound: the entries
    each lane's walk visits, truncation probe included."""
    H = mm.heads.shape[0]
    app32 = int(appended) & 0xFFFFFFFF
    seq = mm.slot_seq.to(torch.int64) & 0xFFFFFFFF
    pos = torch.where(valid, mm.heads[(hashes & (H - 1)).long()], -1)
    alive = valid.clone()
    prev = torch.zeros(pos.shape, dtype=torch.int64, device=pos.device)
    visited = 0
    for _ in range(k_max + 1):
        ok = alive & (pos >= 0)
        visited += int(ok.sum())
        p = torch.where(ok, pos, 0).long()
        age = (app32 - seq[p]) & 0xFFFFFFFF
        alive = ok & (age > prev) & (age <= wlen)
        prev = age
        pos = mm.nexts[p]
    return visited


#: the fused K10 probe's outputs
PROBE_COMPACT_PARTS = ("lane", "row", "pv", "over", "truncated")


def probe_launches(kernels) -> tuple:
    """(fused probe, probe alone, compact_pairs) launches counted."""
    return tuple(kernels.LAUNCHES[k] for k in
                 ("K10 probe compact", "K10 probe", "K10 compact"))


def join_kernel_phase(torch, rng) -> dict:
    """K3b and the three K10 kernels against their plain versions at app
    G's shapes, bit for bit, with their timings."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby, join

    dev = torch.device("cuda")
    res = {}
    B, C, H, K = BATCH_G, LENGTH_G, BUCKETS_G, K_MAX
    P = B * K

    # K3b: app G's key column, as _hash_exprs hashes it (remap), and with
    # the build side's validity mask
    keys = torch.from_numpy(rng.integers(1, C + 1, B).astype(np.int32)).to(
        dev)
    valid = torch.from_numpy(rng.random(B) < 0.9).to(dev)
    sentinel = torch.tensor([0x96825014 - 2**32], dtype=torch.int32,
                            device=dev)  # mixes to 0xFFFFFFFF
    for args in (([keys], True, None), ([keys], True, valid),
                 ([keys], False, None), ([sentinel], True, None)):
        check_equal("K3b", groupby.hash_columns32(*args),
                    groupby.hash_columns32_plain(*args))
    res["K3b"] = dict(
        _timed(torch, lambda: groupby.hash_columns32([keys], True),
               lambda: groupby.hash_columns32_plain([keys], True)),
        bound_ms=bound_ms(B * 4 + B * 4), max_abs_err=0, bound_by="bytes")
    print(f"K3b hash_columns32 n={B}, one int column: {res['K3b']}")

    # K10 append: 30 batches wrap the 100000-slot ring more than twice
    n_batches = 30
    kmm, pmm, appended, (h, live, a0, before) = _build_multimap(
        torch, rng, 0, n_batches)
    if appended < 2 * C + B:
        raise Failure("K10 append: the ring did not wrap twice")
    state = [t.clone() for t in before]
    mm = join.MultimapState(*state)

    def restore():
        for t, t0 in zip(state, before):
            t.copy_(t0)

    n_live = int(live.sum())
    runs = int(torch.unique(h[live] & (H - 1)).numel())
    res["K10 append"] = dict(
        _timed(torch, lambda: join.multimap_append(mm, h, live, a0),
               lambda: join.multimap_append_plain(mm, h, live, a0),
               reset=restore),
        # hashes and live in; three words out per live row; one old head
        # read and one head written per bucket run
        bound_ms=bound_ms(B * (4 + 1) + n_live * 12 + runs * 8),
        max_abs_err=0, bound_by="bytes")
    restore()
    kernels.reset_launch_counts()
    join.multimap_append(mm, h, live, a0)
    print(f"K10 multimap_append B={B} C={C} H={H} (ring wrapped "
          f"{appended // C} times): {res['K10 append']}; "
          f"{kernels.LAUNCHES['K10 append']} launch a call")

    # K10 probe: app G's probe batch against the full window; then against
    # a state whose tags cross 2^32 (the u32 ages wrap)
    pkeys = torch.from_numpy(rng.integers(1, C + 1, B).astype(np.int32)).to(
        dev)
    ph = groupby.hash_columns32([pkeys], True)
    pvalid = torch.from_numpy(rng.random(B) < 0.99).to(dev)
    app_t = torch.tensor(appended, device=dev)
    wlen = torch.tensor(C, device=dev)
    # start so that the last tags pass 2^32 by about half a window
    wstart = 2**32 - n_batches * B * 97 // 100 + C // 2
    wmm, _, wapp, _ = _build_multimap(torch, rng, wstart, n_batches)
    if not 2**32 < wapp < 2**32 + C:
        raise Failure("K10 probe: the tags do not cross 2^32")
    cases = ((kmm, app_t, "appended < 2^32"),
             (wmm, torch.tensor(wapp, device=dev), "appended past 2^32"))
    for m, a, what in cases:
        for wl in (wlen, torch.tensor(C // 3, device=dev)):
            got = join.multimap_probe(m, ph, pvalid, a, wl, K)
            want = join.multimap_probe_plain(m, ph, pvalid, a, wl, K)
            for nm, x, y in zip(("cand_pos", "cand_ok", "truncated"), got,
                                want):
                check_equal(f"K10 probe {what} {nm}", x, y)
            # as the step runs it: the walks write the compacted pairs
            got = join.multimap_probe_compact(m, ph, pvalid, a, wl, K,
                                              PAIR_CAP_G)
            want = join.multimap_probe_compact_plain(m, ph, pvalid, a, wl,
                                                     K, PAIR_CAP_G)
            for nm, x, y in zip(PROBE_COMPACT_PARTS, got, want):
                check_equal(f"K10 probe+compact {what} {nm}", x, y)
    n_cand = int(join.multimap_probe(kmm, ph, pvalid, app_t, wlen,
                                     K)[1].sum())
    visited = _probe_walk(torch, kmm, ph, pvalid, app_t, C, K)
    kernels.reset_launch_counts()
    join.multimap_probe_compact(kmm, ph, pvalid, app_t, wlen, K, PAIR_CAP_G)
    if probe_launches(kernels) != (1, 0, 0):
        raise Failure("K10 probe+compact: not one launch a call")
    res["K10 probe compact"] = dict(
        _timed(torch, lambda: join.multimap_probe_compact(
            kmm, ph, pvalid, app_t, wlen, K, PAIR_CAP_G),
            lambda: join.multimap_probe_compact_plain(
                kmm, ph, pvalid, app_t, wlen, K, PAIR_CAP_G)),
        # hash, valid and a head per lane; 12 bytes per chain entry the
        # walks visit; pair_cap lanes, rows and pv and three counts out
        bound_ms=bound_ms(B * (4 + 1 + 4) + visited * 12
                          + PAIR_CAP_G * (4 + 4 + 1) + 12),
        max_abs_err=0, bound_by="bytes")
    res["K10 probe"] = dict(
        _timed(torch, lambda: join.multimap_probe(kmm, ph, pvalid, app_t,
                                                  wlen, K),
               lambda: join.multimap_probe_plain(kmm, ph, pvalid, app_t,
                                                 wlen, K)),
        # the [B, K] candidates out
        bound_ms=bound_ms(B * (4 + 1 + 4) + visited * 12 + P * (4 + 1)),
        max_abs_err=0, bound_by="bytes")
    print(f"K10 multimap_probe + compact_pairs B={B} k_max={K} pair_cap="
          f"{PAIR_CAP_G} (one launch): {n_cand} candidates, {visited} chain "
          f"entries read: {res['K10 probe compact']}")
    print(f"K10 multimap_probe alone (the [B, k_max] block, where the step "
          f"does not compact): {res['K10 probe']}")

    # K10 compact: P candidates into pair_cap, at app G's density (~1
    # match a probe) and past pair_cap
    lane = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand(
        B, K).reshape(-1)
    row = torch.from_numpy(rng.integers(0, C, P).astype(np.int32)).to(dev)
    dense = torch.from_numpy(rng.random(P) < 0.4).to(dev)
    if int(dense.sum()) <= PAIR_CAP_G:
        raise Failure("K10 compact: the overflow case does not overflow")
    sparse = torch.from_numpy(rng.random(P) < 1 / K).to(dev)
    for nm, pv in (("past pair_cap", dense), ("app G density", sparse)):
        got = join.compact_pairs(lane, row, pv, PAIR_CAP_G)
        want = join.compact_pairs_plain(lane, row, pv, PAIR_CAP_G)
        for part, x, y in zip(("lane", "row", "valid"), got, want):
            check_equal(f"K10 compact {nm} {part}", x, y)
    kept = min(int(sparse.sum()), PAIR_CAP_G)

    def library():  # nonzero_static at the known count: no host sync
        idx = torch.nonzero_static(sparse, size=kept).squeeze(1)
        return lane.index_select(0, idx), row.index_select(0, idx)

    res["K10 compact"] = dict(
        _timed(torch,
               lambda: join.compact_pairs(lane, row, sparse, PAIR_CAP_G),
               lambda: join.compact_pairs_plain(lane, row, sparse,
                                                PAIR_CAP_G),
               library=library),
        # lanes, rows and valid in; pair_cap lanes, rows and valid out
        bound_ms=bound_ms(P * (4 + 4 + 1) + PAIR_CAP_G * (4 + 4 + 1)),
        max_abs_err=0, bound_by="bytes")
    print(f"K10 compact_pairs P={P} pair_cap={PAIR_CAP_G} kept={kept}: "
          f"{res['K10 compact']}")

    # the two probes that are compositions: app G's probe batch (B = 8192,
    # k_max = 16) against a C = 100000-row build side, 90% valid
    from siddhi_tpu_torch.ops.expr_compile import CompiledExpr, Scope
    from siddhi_tpu_torch.query_api.definition import AttributeType
    bkeys = torch.from_numpy(rng.integers(1, C + 1, C).astype(np.int32)).to(
        dev)
    bvalid = torch.from_numpy(rng.random(C) < 0.9).to(dev)
    bts = torch.arange(C, dtype=torch.int64, device=dev)
    plan = join.JoinPlan(
        [CompiledExpr(lambda s: s.col("p", "k"), AttributeType.INT)],
        [CompiledExpr(lambda s: s.col("b", "k"), AttributeType.INT)], None)
    pscope = Scope()
    pscope.add_frame("p", {"k": pkeys}, torch.zeros(B, dtype=torch.int64,
                                                     device=dev), pvalid)
    compositions = {
        "probe_equi": dict(
            ms=device_ms(torch, lambda: join.probe_equi(
                plan, pscope, pvalid, {"k": bkeys}, bts, bvalid, "b", K)),
            # probe and build keys and valid in; the [B, k_max] lanes, rows
            # and valid out
            bound_ms=bound_ms(B * (4 + 1) + C * (4 + 1) + P * (4 + 4 + 1)),
            bound_by="bytes", shape=f"B={B} into C={C}, k_max={K}"),
        "probe_cross": dict(
            ms=device_ms(torch, lambda: join.probe_cross(pvalid, bvalid, K)),
            bound_ms=bound_ms(B + C + P * (4 + 4 + 1)), bound_by="bytes",
            shape=f"B={B} against C={C}, k_max={K}")}
    print("join compositions: " + json.dumps(compositions))
    torch.cuda.synchronize()
    return res


def k10_edge_cases(torch, rng, dev, B: int = BATCH_G, C: int = LENGTH_G,
                   B_big: int = 131_072, C_big: int = 262_144) -> dict:
    """name -> (state, hashes, live, appended0) of K10 append's edges: a
    multimap over a C-slot ring that two earlier all-live batches filled
    (by the plain append), and the batch appended to it. App G's shape,
    every live lane in one bucket, 16 keys, every lane dead, B = 1, B = C,
    a batch across the ring's end, tags across 2^32, one lane past the
    kernel's 8,192-lane tile, and B_big lanes into C_big (uniform keys and
    one bucket: the cooperative grid)."""
    from siddhi_tpu_torch.ops import groupby, join

    def case(b, c, keys, p_live, end_at):
        H = join.multimap_buckets(c)
        mm = join.multimap_init(c, H, dev)
        nb = min(b, c)
        a = end_at - 2 * nb
        for _ in range(2):
            pk = torch.from_numpy(rng.integers(1, c + 1, nb).astype(
                np.int32)).to(dev)
            mm = join.multimap_append_plain(
                mm, groupby.hash_columns32_plain([pk], remap=True),
                torch.ones(nb, dtype=torch.bool, device=dev),
                torch.tensor(a, device=dev))
            a += nb
        kt = torch.from_numpy(np.asarray(keys, dtype=np.int32)).to(dev)
        live = torch.from_numpy(rng.random(b) < p_live).to(dev)
        return (mm, groupby.hash_columns32_plain([kt], remap=True), live,
                torch.tensor(end_at, device=dev))

    def uniform(b, c):
        return rng.integers(1, c + 1, b)

    return {
        "app G's shape": case(B, C, uniform(B, C), 0.97, 5 * C + 12_345),
        "every live lane one bucket": case(B, C, np.full(B, 7), 0.97,
                                           3 * C + 100),
        "16 keys": case(B, C, rng.integers(1, 17, B), 0.97, 4 * C),
        "every lane dead": case(B, C, uniform(B, C), 0.0, 2 * C + 5),
        "B = 1": case(1, C, [42], 1.0, C + 3),
        "B = C": case(C, C, uniform(C, C), 0.97, 6 * C + 777),
        "across the ring's end": case(B, C, uniform(B, C), 0.97,
                                      7 * C - B // 2),
        "tags across 2^32": case(B, C, uniform(B, C), 0.97, 2**32 - B // 3),
        "one lane past a tile": case(K10_TILE + 1, C,
                                     uniform(K10_TILE + 1, C), 0.97, 3 * C),
        "B = 131072 into C = 262144": case(B_big, C_big,
                                           uniform(B_big, C_big), 0.97,
                                           5 * C_big + 99),
        "131072 lanes, one bucket": case(B_big, C_big, np.full(B_big, 5),
                                         0.97, 2 * C_big + 1),
    }


#: K10 append's one-block limit (csrc/k10_join.cu ATILE)
K10_TILE = 8192


def run_k10_case(join, case, plain: bool):
    """The state after appending the case's batch to a copy of its
    multimap, by the kernel or by the plain version."""
    mm, hashes, live, a0 = case
    state = join.MultimapState(*[t.clone() for t in mm])
    fn = join.multimap_append_plain if plain else join.multimap_append
    return fn(state, hashes, live, a0)


#: probe lanes past what the card holds at once (132 SMs x 2,048 threads)
BIG_PROBE = 300_000


def k10_probe_edge_cases(torch, rng, dev, B: int = BATCH_G,
                         C: int = LENGTH_G, K: int = K_MAX,
                         cap: int = PAIR_CAP_G) -> dict:
    """name -> (state, hashes, valid, appended, window_len, k_max,
    pair_cap) of the fused K10 probe's edges: a multimap over a C-slot
    ring filled by `n` batches of B lanes (97% live, by the plain append)
    and a probe batch. App G's shape (the window full), pair_cap overflow
    (16 keys), every lane invalid, one hot key walking past k_max (a tenth
    of the window one key, half the probe lanes that key), tags across
    2^32, k_max = 1, B = 1, a partial tile (B = 1000) and more tiles than
    the card holds at once (B = 300,000: a block walks its tiles again
    after the barrier)."""
    from siddhi_tpu_torch.ops import groupby, join
    fill = -(-C // B)  # batches that fill the window

    def case(keys_of, n, start, probe, valid_p=0.99, k=K, pcap=cap,
             window=C):
        H = join.multimap_buckets(C)
        mm = join.multimap_init(C, H, dev)
        a = start
        for _ in range(n):
            kt = torch.from_numpy(keys_of(B).astype(np.int32)).to(dev)
            live = torch.from_numpy(rng.random(B) < 0.97).to(dev)
            mm = join.multimap_append_plain(
                mm, groupby.hash_columns32_plain([kt], remap=True), live,
                torch.tensor(a, device=dev))
            a += int(live.sum())
        pk = torch.from_numpy(np.asarray(probe, dtype=np.int32)).to(dev)
        valid = torch.from_numpy(rng.random(pk.shape[0]) < valid_p).to(dev)
        return (mm, groupby.hash_columns32_plain([pk], remap=True), valid,
                torch.tensor(a, device=dev), torch.tensor(window,
                                                          device=dev),
                k, pcap)

    def uniform(b):
        return rng.integers(1, C + 1, b)

    def hot(b):
        return np.where(rng.random(b) < 0.1, 7, rng.integers(1, C + 1, b))

    return {
        "app G's shape": case(uniform, fill, 3 * C, uniform(B)),
        "pair_cap overflow": case(lambda b: rng.integers(1, 17, b), 2, 0,
                                  rng.integers(1, 17, B)),
        "every lane invalid": case(uniform, 2, 5, uniform(B), valid_p=0.0),
        "one hot key past k_max": case(
            hot, fill, C, np.where(rng.random(B) < 0.5, 7, uniform(B))),
        "tags across 2^32": case(uniform, fill, 2**32 - C // 2, uniform(B)),
        "k_max = 1": case(lambda b: rng.integers(1, 2001, b), 2, 11,
                          rng.integers(1, 2001, B), k=1, pcap=B // 8),
        "B = 1": case(uniform, 2, 0, [42], pcap=8),
        "B = 1000, a partial tile": case(uniform, 2, 0, uniform(1000),
                                         pcap=4000),
        "B = 300000, tiles past the card": case(
            uniform, 2, 7, uniform(BIG_PROBE), pcap=4 * BIG_PROBE),
    }



def run_k10_probe_case(join, case, plain: bool):
    """The fused probe's five outputs, by the kernel or by the plain
    version."""
    fn = (join.multimap_probe_compact_plain if plain
          else join.multimap_probe_compact)
    return fn(*case)


def append_bytes(torch, case) -> int:
    """K10 append's bound: hashes and live in; three words out per live
    row; one old head read and one head written per bucket."""
    mm, hashes, live, _ = case
    H = mm.heads.shape[0]
    runs = int(torch.unique(hashes[live] & (H - 1)).numel())
    return hashes.shape[0] * (4 + 1) + int(live.sum()) * 12 + runs * 8


def multimap_edge_phase(torch, rng) -> None:
    """Phase 8's K10 append edges against the plain version, the whole
    state bit for bit, one launch a call; a large and a small multimap
    alternate on one stream; the skewed and the many-block appends timed
    at full size."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import join
    cases = k10_edge_cases(torch, rng, torch.device("cuda"))
    big, small = "B = 131072 into C = 262144", "app G's shape"
    for name in list(cases) + [big, small, big, small]:
        kernels.reset_launch_counts()
        got = run_k10_case(join, cases[name], plain=False)
        want = 0 if cases[name][1].shape[0] == 0 else 1
        if kernels.LAUNCHES["K10 append"] != want:
            raise Failure(f"K10 append edge {name}: "
                          f"{kernels.LAUNCHES['K10 append']} launches, one "
                          "a call expected")
        _check_state(f"K10 append edge {name}", got,
                     run_k10_case(join, cases[name], plain=True))
    print(f"K10 append edges: {len(cases)} cases bit for bit, one launch a "
          "call (small and large multimaps alternating)")
    probes = k10_probe_edge_cases(torch, rng, torch.device("cuda"))
    seen = {}
    for name, case in probes.items():
        kernels.reset_launch_counts()
        got = run_k10_probe_case(join, case, plain=False)
        launched = probe_launches(kernels)
        if launched != (1, 0, 0):
            raise Failure(f"K10 probe+compact edge {name}: launches (fused, "
                          f"probe, compact) {launched}, (1, 0, 0) expected")
        for nm, x, y in zip(PROBE_COMPACT_PARTS, got,
                            run_k10_probe_case(join, case, plain=True)):
            check_equal(f"K10 probe+compact edge {name} {nm}", x, y)
        ws = kernels.workspace("k10_join", 0, torch.device("cuda"))
        if int(ws.count_nonzero()):
            raise Failure(f"K10 probe+compact edge {name}: the workspace "
                          "is not zero after the call")
        seen[name] = (int(got[2].sum()), int(got[3]), int(got[4]))
    if (seen["pair_cap overflow"][1] == 0
            or seen["one hot key past k_max"][2] == 0
            or seen["every lane invalid"] != (0, 0, 0)):
        raise Failure(f"K10 probe+compact edges: (pairs, over, truncated) "
                      f"{seen}")
    print(f"K10 probe+compact edges: {len(probes)} cases bit for bit, one "
          f"launch a call, (pairs, over, truncated) {seen}")
    for name in ("pair_cap overflow", "one hot key past k_max"):
        case = probes[name]
        row = dict(ms=device_ms(torch, lambda: run_k10_probe_case(
                       join, case, plain=False)),
                   call_ms=time_ms(torch, lambda: run_k10_probe_case(
                       join, case, plain=False)))
        print(f"K10 multimap_probe + compact_pairs {name}: "
              f"{json.dumps(row)}")
    for name in ("every live lane one bucket", big,
                 "131072 lanes, one bucket"):
        mm, h, live, a0 = case = cases[name]
        state = [t.clone() for t in mm]
        work = join.MultimapState(*state)

        def restore():
            for t, t0 in zip(state, mm):
                t.copy_(t0)

        kernels.reset_launch_counts()
        join.multimap_append(work, h, live, a0)
        row = dict(launches_a_call=kernels.LAUNCHES["K10 append"],
                   ms=device_ms(torch, lambda: join.multimap_append(
                       work, h, live, a0), reset=restore),
                   call_ms=time_ms(torch, lambda: join.multimap_append(
                       work, h, live, a0), reset=restore),
                   bound_ms=bound_ms(append_bytes(torch, case)))
        print(f"K10 multimap_append {name} (B={h.shape[0]}, "
              f"C={mm.nexts.shape[0]}): {json.dumps(row)}")


def join_events(rng):
    """App G's feed: per side, keys uniform over 1..LENGTH_G, values
    uniform on [1, 100); round r's left batch then its right batch, 1 ms
    apart."""
    n = BATCH_G * ROUNDS_G
    k = {s: rng.integers(1, LENGTH_G + 1, n).astype(np.int32)
         for s in ("L", "R")}
    v = {s: rng.uniform(1.0, 100.0, n) for s in ("L", "R")}
    base = 1_700_000_000_000
    r = np.arange(n) // BATCH_G
    i = np.arange(n) % BATCH_G
    ts = {"L": base + (2 * r) * BATCH_G + i,
          "R": base + (2 * r + 1) * BATCH_G + i}
    return k, v, {s: t.astype(np.int64) for s, t in ts.items()}


def oracle_g(k, v, ts):
    """Per probe event in arrival order, the equal-key rows among the
    other side's last LENGTH_G arrivals, oldest first: (k, lv, rv, ts) as
    the port stores the values (float32), and the largest match count."""
    v32 = {s: v[s].astype(np.float32).astype(np.float64) for s in v}
    out_k, out_lv, out_rv, out_ts = [], [], [], []
    most = 0
    for r in range(ROUNDS_G):
        for probe, build in (("L", "R"), ("R", "L")):
            lo = r * BATCH_G
            n_build = lo + (BATCH_G if probe == "R" else 0)
            start = max(0, n_build - LENGTH_G)
            wk = k[build][start:n_build]
            order = np.argsort(wk, kind="stable")
            sk = wk[order]
            pk = k[probe][lo:lo + BATCH_G]
            a = np.searchsorted(sk, pk, side="left")
            cnt = np.searchsorted(sk, pk, side="right") - a
            most = max(most, int(cnt.max()) if cnt.size else 0)
            rep = np.repeat(np.arange(BATCH_G), cnt)
            offs = np.arange(rep.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            brow = start + order[a[rep] + offs]
            prow = lo + rep
            out_k.append(pk[rep])
            out_ts.append(ts[probe][prow])
            pv, bv = v32[probe][prow], v32[build][brow]
            out_lv.append(pv if probe == "L" else bv)
            out_rv.append(bv if probe == "L" else pv)
    cat = np.concatenate
    return cat(out_k), cat(out_lv), cat(out_rv), cat(out_ts), most


def run_join_app(torch, k, v, ts):
    from siddhi_tpu_torch import SiddhiManager, kernels

    rt = SiddhiManager().create_siddhi_app_runtime(APP_G, batch_size=BATCH_G)
    got = []
    rt.add_callback("OutStream", got.extend)
    hs = {"L": rt.get_input_handler("LeftStream"),
          "R": rt.get_input_handler("RightStream")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(ROUNDS_G):
        s = slice(r * BATCH_G, (r + 1) * BATCH_G)
        for side in ("L", "R"):
            hs[side].send_columns({"k": k[side][s], "v": v[side][s]},
                                  timestamps=ts[side][s])
            rt.flush()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return rt, got, launches, elapsed, peak


def measure_join_steps(torch, rt, k, v, ts):
    """Both join steps alone over app G's rounds from a fresh state, as
    device batches prepared beforehand; (host syncs in one left and one
    right step, mean ms per round)."""
    from siddhi_tpu_torch.core.event import EventBatch

    jr = rt.query_runtimes["bench"]
    codecs = {"L": rt.junctions["LeftStream"].codec,
              "R": rt.junctions["RightStream"].codec}
    dev = torch.device("cuda")
    rounds = []
    for r in range(ROUNDS_G):
        s = slice(r * BATCH_G, (r + 1) * BATCH_G)
        rounds.append([
            (EventBatch.from_numpy(ts[side][s], codecs[side].encode_columns(
                {"k": k[side][s], "v": v[side][s]}, BATCH_G), BATCH_G, dev),
             int(ts[side][s].max()))
            for side in ("L", "R")])
    jr.state = jr.init_state()

    def first_round():
        for (b, now), step in zip(rounds[0], (jr._step_left,
                                              jr._step_right)):
            jr.state, _, _ = step(jr.state, b, now)

    syncs = syncs_in(torch, first_round)
    jr.state = jr.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for (bl, nl), (br, nr) in rounds:
        jr.state, _, _ = jr._step_left(jr.state, bl, nl)
        jr.state, _, _ = jr._step_right(jr.state, br, nr)
    torch.cuda.synchronize()
    return syncs, (time.perf_counter() - t0) / ROUNDS_G * 1e3


def check_join(name: str, got, want) -> int:
    """Every output event, in order, against the oracle's (k, lv, rv,
    ts)."""
    want_k, want_lv, want_rv, want_ts = want
    n = want_ts.shape[0]
    if len(got) != n:
        raise Failure(f"app {name}: {len(got)} events out, the oracle "
                      f"expects {n}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, n)
    g = [np.fromiter((e.data[i] for e in got),
                     np.int64 if i == 0 else np.float64, n) for i in range(3)]
    for what, a, b in (("timestamp", g_ts, want_ts), ("k", g[0], want_k),
                       ("lv", g[1], want_lv), ("rv", g[2], want_rv)):
        bad = np.nonzero(a != b)[0]
        if bad.size:
            j = int(bad[0])
            raise Failure(f"app {name}: {what} of event {j} is {a[j]}, the "
                          f"oracle says {b[j]}")
    return n


def join_app(torch, rng, card: str, summary=None) -> dict:
    """App G against its oracle, also through the columnar async path when
    `summary` is given; returns its launches."""
    k, v, ts = join_events(rng)
    want_k, want_lv, want_rv, want_ts, most = oracle_g(k, v, ts)
    if most > K_MAX:
        raise Failure(f"app G: a probe has {most} matches, past k_max")
    with counting_calls(K10_SITES) as k10:
        rt, got, launches, elapsed, peak = run_join_app(torch, k, v, ts)
    check_one_launch_a_call("G", launches, "K10 append", k10["calls"])
    want = (want_k, want_lv, want_rv, want_ts)
    n = check_join("G", got, want)
    del got
    dropped = rt.query_runtimes["bench"]._dropped_dev
    if dropped is not None and int(dropped) != 0:
        raise Failure(f"app G: {int(dropped)} pairs dropped")
    for kname in ("K1", "K2b pack", "K2b fetch", "K2b append", "K2b gather",
                  "K3b", "K10 append", "K10 probe compact", "K12a",
                  "K7 merge"):
        if launches[kname] == 0:
            raise Failure(f"app G: kernel {kname} never launched")
    # each probe step compacts in its one probe launch
    g_probes = tuple(launches[kk] for kk in
                     ("K10 probe compact", "K10 probe", "K10 compact"))
    if g_probes != (2 * ROUNDS_G, 0, 0):
        raise Failure(f"app G: (fused probe, probe, compact) launches "
                      f"{g_probes}, ({2 * ROUNDS_G}, 0, 0) expected")
    syncs, step_ms = measure_join_steps(torch, rt, k, v, ts)
    report_app("G", 2 * BATCH_G * ROUNDS_G, n, elapsed, step_ms, peak,
               launches, syncs, card, rounds=ROUNDS_G,
               batch=f"2 x {BATCH_G}")
    if syncs:
        raise Failure(f"app G: the join step syncs with the host: {syncs}")
    del rt
    # the same app with pair_cap = B * k_max (a pair cap factor of k_max):
    # no step compacts, so the probe writes its [B, k_max] block alone
    from siddhi_tpu_torch.core import dtypes
    factor = dtypes.config.join_pair_cap_factor
    dtypes.config.join_pair_cap_factor = K_MAX
    try:
        rt, got, full, elapsed_full, _ = run_join_app(torch, k, v, ts)
    finally:
        dtypes.config.join_pair_cap_factor = factor
    check_join("G (pair cap factor 16)", got, want)
    del got, rt
    g_probes = tuple(full[kk] for kk in
                     ("K10 probe compact", "K10 probe", "K10 compact"))
    if g_probes != (0, 2 * ROUNDS_G, 0):
        raise Failure(f"app G at pair cap factor {K_MAX}: (fused probe, "
                      f"probe, compact) launches {g_probes}, (0, "
                      f"{2 * ROUNDS_G}, 0) expected")
    print(f"app G at pair cap factor {K_MAX} (no step compacts): matches "
          f"the oracle in {elapsed_full:.3f} s, (fused probe, probe, "
          f"compact) launches {g_probes}")
    launches = {kk: launches[kk] + full[kk] for kk in launches}
    if summary is not None:
        sends = []
        for r in range(ROUNDS_G):
            s = slice(r * BATCH_G, (r + 1) * BATCH_G)
            for side, stream in (("L", "LeftStream"), ("R", "RightStream")):
                sends.append((stream, {"k": k[side][s], "v": v[side][s]},
                              ts[side][s]))
        col = columnar_pair(torch, "G", APP_G, sends, "OutStream", BATCH_G,
                            ROUNDS_G, lambda g: check_join("G", g, want),
                            elapsed, card, summary)
        launches = {kk: launches[kk] + col[kk] for kk in launches}
    return launches


# --------------------------------------------------------------------------- #
# phases 10-11: the pattern kernels, apps H and I
# --------------------------------------------------------------------------- #


def pattern_events(rng, app: str, rounds: int = ROUNDS_P,
                   batch: int = BATCH_P):
    """Apps H and I's feed: {"A": (val int32, ts int64), "B": ...}, round r
    one A batch then one B batch. H is bench.py's: val = arange(v0, v0 +
    batch) on both streams, v0 growing each round; A at 10000 r + i // 64
    ms, B 1000 ms later. I: values uniform over 1..VALUES_I (scaled with
    the batch) on each stream, A at 3000 r + i // 64, B 1000 ms later."""
    n = rounds * batch
    r = np.arange(n) // batch
    i = np.arange(n) % batch
    if app == "H":
        va = vb = np.arange(n, dtype=np.int32)
        period = 10_000
    else:
        hi = max(1, round(VALUES_I * batch / BATCH_P))
        va = rng.integers(1, hi + 1, n).astype(np.int32)
        vb = rng.integers(1, hi + 1, n).astype(np.int32)
        period = 3_000
    ta = (period * r + i // 64).astype(np.int64)
    return {"A": (va, ta), "B": (vb, ta + 1000)}


def pattern_nows(data, rounds: int, batch: int) -> list:
    """The playback clock at each step (A then B per round): the largest
    event timestamp seen so far."""
    nows, now = [], -(2**62)
    for r in range(rounds):
        for side in ("A", "B"):
            now = max(now, int(data[side][1][r * batch:(r + 1) * batch].max()))
            nows.append(now)
    return nows


def oracle_pattern(data, rounds: int, batch: int, pending: int,
                   within: int = WITHIN_P):
    """`every a=A -> b=B[b.val == a.val] within` step by step on a model of
    the pending table: at each step, entries with now - start > within
    expire; an A batch's arrivals take the free slots in ascending slot
    order (past them they are dropped); a B batch consumes each live entry
    with its first equal-valued arrival inside `within`, emitted in slot
    order. Returns (ts, aVal, bVal) arrays and the dropped count."""
    (va, ta), (vb, tb) = data["A"], data["B"]
    live = np.zeros(pending, bool)
    sval = np.zeros(pending, np.int32)
    sts = np.zeros(pending, np.int64)
    out_ts, out_a, out_b = [], [], []
    dropped = 0
    nows = iter(pattern_nows(data, rounds, batch))
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        live &= next(nows) - sts <= within
        free = np.flatnonzero(~live)
        k = min(free.size, batch)
        dropped += batch - k
        live[free[:k]] = True
        sval[free[:k]] = va[s][:k]
        sts[free[:k]] = ta[s][:k]
        live &= next(nows) - sts <= within
        bv, bt = vb[s], tb[s]
        order = np.argsort(bv, kind="stable")
        first = np.searchsorted(bv[order], sval, side="left")
        lane = order[np.minimum(first, batch - 1)]
        hit = (live & (first < batch) & (bv[lane] == sval)
               & (bt[lane] - sts <= within))
        slots = np.flatnonzero(hit)  # ascending: the emission order
        out_ts.append(bt[lane[slots]])
        out_a.append(sval[slots])
        out_b.append(bv[lane[slots]])
        live[slots] = False
    cat = np.concatenate
    return cat(out_ts), cat(out_a), cat(out_b), dropped


def check_no_tie(data, rounds: int, batch: int, within: int = WITHIN_P):
    """No A timestamp lies exactly `within` before a B timestamp or a step's
    clock, so the oracle's `<=` never meets a tie."""
    ta, tb = data["A"][1], data["B"][1]
    edges = np.concatenate([tb, np.asarray(pattern_nows(data, rounds, batch))])
    if np.isin(ta + within, edges).any():
        raise Failure("pattern data: a timestamp difference equals within")


def _pattern_batch(torch, rng, B, P, seq0, valid_p=0.97, fill=0.45):
    """A K11a case at app I's shapes: a batch of B arrivals (valid_p of
    them valid, values uniform, ts as app I's B side) and a P-slot pending
    table `fill` full in scattered slots, with last_seq mostly before the
    batch and some inside it, and start_ts so that `within` cuts some."""
    dev = torch.device("cuda")
    hi = VALUES_I
    valid = rng.random(B) < valid_p
    rank = np.cumsum(valid) - 1
    arr_seq = np.where(valid, seq0 + rank, 2**62).astype(np.int64)
    ts = (3000 * 7 + 1000 + np.arange(B) // 64).astype(np.int64)
    bval = rng.integers(1, hi + 1, B).astype(np.int32)
    pend_valid = rng.random(P) < fill
    inside = rng.random(P) < 0.1
    last_seq = np.where(inside, seq0 + rng.integers(-1, B, P),
                        seq0 - 1 - rng.integers(0, 10**6, P))
    start_ts = ts[0] - rng.integers(0, 5600, P)
    eval_ = rng.integers(1, hi + 1, P).astype(np.int32)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in (
        ("valid", valid), ("arr_seq", arr_seq), ("ts", ts), ("bval", bval),
        ("pend_valid", pend_valid), ("last_seq", last_seq.astype(np.int64)),
        ("start_ts", start_ts.astype(np.int64)), ("eval", eval_))}
    t["seq0"] = torch.tensor(seq0, dtype=torch.int64, device=dev)
    t["lane_ok"] = t["valid"] & (t["bval"] % 11 != 0)
    return t


def pattern_kernel_phase(torch, rng) -> dict:
    """K11a and K11b against their plain versions at app I's shapes, bit
    for bit, with their timings."""
    from siddhi_tpu_torch.ops import pattern

    dev = torch.device("cuda")
    res = {}
    B, P = BATCH_P, PENDING_P
    t = _pattern_batch(torch, rng, B, P, seq0=5_000_000)

    def resid(p0, p1):
        return (t["bval"][:, None] + t["eval"][None, p0:p1]) % 3 != 0

    # sequence mode compares values over 1..4, so a quarter of the next
    # lanes match
    small = {"bval": (t["bval"] % 4).contiguous(),
             "eval": (t["eval"] % 4).contiguous()}

    def args(sequence, residual, lane_ok):
        v = small if sequence else t
        return ((t["arr_seq"], t["ts"], t["valid"], lane_ok,
                 [(v["bval"], v["eval"])], t["pend_valid"], t["last_seq"],
                 t["start_ts"], WITHIN_P, sequence),
                dict(seq0=t["seq0"], residual=residual))

    # sequence mode: move most live entries' last_seq next to a lane
    seq_last = torch.where(
        torch.from_numpy(rng.random(P) < 0.8).to(dev),
        t["seq0"] - 1 + torch.from_numpy(rng.integers(-3, B + 3, P)).to(dev),
        t["last_seq"])
    n_hits = {}
    for sequence in (False, True):
        for residual in (None, resid):
            a, kw = args(sequence, residual, t["lane_ok"])
            if sequence:
                a = a[:6] + (seq_last,) + a[7:]
            got = pattern.first_match(*a, **kw)
            want = pattern.first_match_plain(*a, **kw)
            what = (f"K11a {'sequence' if sequence else 'pattern'} "
                    f"{'with' if residual else 'without'} residual")
            for nm, x, y in zip(("b_star", "matched", "killed"), got, want):
                check_equal(f"{what} {nm}", x, y)
            n_hits[what] = (int(got[1].sum()), int(got[2].sum()))
    print(f"K11a checks (matched, killed): {n_hits}")
    a, kw = args(False, None, t["valid"])  # the path's case: no lane mask
    got = pattern.first_match(*a, **kw)
    for nm, x, y in zip(("b_star", "matched", "killed"), got,
                        pattern.first_match_plain(*a, **kw)):
        check_equal(f"K11a app I shape {nm}", x, y)
    res["K11a"] = dict(
        _timed(torch, lambda: pattern.first_match(*a, **kw),
               lambda: pattern.first_match_plain(*a, **kw)),
        # lanes: arr_seq, ts, valid, lane_ok, value; entries: valid,
        # last_seq, start_ts, value in, b_star, matched, killed out
        bound_ms=bound_ms(B * (8 + 8 + 1 + 1 + 4) + P * (1 + 8 + 8 + 4)
                          + P * (8 + 1 + 1)),
        max_abs_err=0, bound_by="bytes")
    print(f"K11a first_match B={B} P={P} ({int(t['pend_valid'].sum())} live"
          f", {int(got[1].sum())} matched): {res['K11a']}")
    # the K7 sort K11a's index runs on the batch's equality column
    from siddhi_tpu_torch.ops import search
    key = t["bval"]
    check_equal("K7 pattern index", search.stable_radix_argsort(
        key, counter="K7 pattern index"),
        search.stable_radix_argsort_plain(key))
    res["K7 pattern index"] = dict(
        _timed(torch, lambda: search.stable_radix_argsort(
            key, counter="K7 pattern index"),
            lambda: search.stable_radix_argsort_plain(key),
            library=lambda: torch.sort(key, stable=True)),
        bound_ms=bound_ms(B * 4 + B * 4), max_abs_err=0, bound_by="bytes")
    print(f"K7 pattern index, B={B} int32 values: {res['K7 pattern index']}")

    # K11b: app I's candidates (one A batch) into position 1's table
    def table(fill):
        live = torch.from_numpy(rng.random(P) < fill).to(dev)
        z = torch.zeros(P, dtype=torch.int64, device=dev)
        r64 = torch.from_numpy(rng.integers(0, 2**40, P)).to(dev)
        return pattern.PendingTable(
            frames={"a": {"val": torch.from_numpy(rng.integers(
                1, VALUES_I, P).astype(np.int32)).to(dev)}},
            frame_valid={"a": live.clone()}, frame_ts={"a": r64.clone()},
            start_ts=r64.clone(), last_seq=r64 + 7, armed_ts=z + 3,
            valid=live,
            leg_done=torch.from_numpy(rng.random((P, 2)) < 0.1).to(dev),
            origin=torch.full((P,), -1, dtype=torch.int32, device=dev))

    m = torch.from_numpy(rng.random(B) < 0.97).to(dev)
    cand = ({"a": {"val": t["bval"]}}, {"a": m}, {"a": t["ts"]}, t["ts"],
            t["arr_seq"], t["ts"], m)
    drops = {}
    for name, fill in (("45% full", 0.45), ("overflow", 0.9)):
        dst = table(fill)
        clone = pattern.PendingTable(
            {"a": {"val": dst.frames["a"]["val"].clone()}},
            {"a": dst.frame_valid["a"].clone()},
            {"a": dst.frame_ts["a"].clone()},
            *[x.clone() for x in dst[3:]])
        want, wdrop = pattern.pending_insert_plain(dst, *cand)
        got, gdrop = pattern.pending_insert(clone, *cand)
        check_equal(f"K11b {name} n_drop", gdrop, wdrop)
        check_equal(f"K11b {name} val", got.frames["a"]["val"],
                    want.frames["a"]["val"])
        check_equal(f"K11b {name} frame_valid", got.frame_valid["a"],
                    want.frame_valid["a"])
        check_equal(f"K11b {name} frame_ts", got.frame_ts["a"],
                    want.frame_ts["a"])
        for f in ("start_ts", "last_seq", "armed_ts", "valid", "leg_done",
                  "origin"):
            check_equal(f"K11b {name} {f}", getattr(got, f),
                        getattr(want, f))
        drops[name] = int(gdrop)
        if name == "45% full":
            saved = [x.clone() for x in (dst.frames["a"]["val"],
                                         dst.frame_valid["a"],
                                         dst.frame_ts["a"], *dst[3:])]
            work = clone
            n_fit = int(m.sum())
    if drops["overflow"] == 0 or drops["45% full"] != 0:
        raise Failure(f"K11b: drop counts {drops}")

    def restore():
        for x, x0 in zip((work.frames["a"]["val"], work.frame_valid["a"],
                          work.frame_ts["a"], *work[3:]), saved):
            x.copy_(x0)

    res["K11b"] = dict(
        _timed(torch, lambda: pattern.pending_insert(work, *cand),
               lambda: pattern.pending_insert_plain(work, *cand),
               reset=restore),
        # candidate valid and the table's valid read; per fitting
        # candidate its val, ts, start/last/armed read and val, frame
        # valid and ts, start/last/armed, valid, leg_done, origin written
        bound_ms=bound_ms(B + P + n_fit * (4 + 8 + 3 * 8)
                          + n_fit * (4 + 1 + 8 + 3 * 8 + 1 + 2 + 4)),
        max_abs_err=0, bound_by="bytes")
    print(f"K11b pending_insert W={B} into P={P} (drops {drops}): "
          f"{res['K11b']}")
    torch.cuda.synchronize()
    return res


def _pending(torch, rng, dev, P: int, refs, fill: float, attrs=("val",)):
    """A pending table (or a candidate block) of P slots, `fill` of them
    valid in scattered slots, with an int32 column a ref for each attr."""
    from siddhi_tpu_torch.ops import pattern

    live = torch.from_numpy(rng.random(P) < fill).to(dev)

    def col(dt, hi=2**40):
        return torch.from_numpy(rng.integers(0, hi, P)).to(dev).to(dt)

    return pattern.PendingTable(
        frames={r: {a: col(torch.int32, VALUES_I) for a in attrs}
                for r in refs},
        frame_valid={r: col(torch.bool, 2) for r in refs},
        frame_ts={r: col(torch.int64) for r in refs},
        start_ts=col(torch.int64), last_seq=col(torch.int64),
        armed_ts=col(torch.int64), valid=live,
        leg_done=torch.from_numpy(rng.random((P, 2)) < 0.1).to(dev),
        origin=col(torch.int32, 1000))


def _pending_clone(t):
    from siddhi_tpu_torch.ops import pattern
    return pattern.PendingTable(
        {r: {n: c.clone() for n, c in cs.items()}
         for r, cs in t.frames.items()},
        {r: v.clone() for r, v in t.frame_valid.items()},
        {r: v.clone() for r, v in t.frame_ts.items()},
        *[x.clone() for x in t[3:]])


def _pending_tensors(t) -> list:
    """(name, tensor) of every column of a pending table."""
    out = [(f"{r}.{n}", c) for r, cs in t.frames.items()
           for n, c in cs.items()]
    out += [(f"frame_valid {r}", v) for r, v in t.frame_valid.items()]
    out += [(f"frame_ts {r}", v) for r, v in t.frame_ts.items()]
    return out + [(f, getattr(t, f)) for f in t._fields[3:]]


def k11b_edge_cases(torch, rng, dev, W: int = BATCH_P,
                    P: int = PENDING_P) -> dict:
    """name -> (table, candidate args) of K11b's edges: app I's shape (W
    candidates into P slots, 45% full), no free slot, more candidates than
    free slots, W = 0, P not a multiple of the block (5,001 slots, 3,001
    candidates), more than 32 column jobs (7 of 9 refs of 4 columns: 48
    jobs), an empty table, one block (300 candidates into 1,000 slots: a
    plain launch)."""
    def case(w, p, fill, refs=("a",), cand_refs=("a",),
             attrs=("val",)):
        dst = _pending(torch, rng, dev, p, refs, fill, attrs)
        c = _pending(torch, rng, dev, w, cand_refs, 0.97, attrs)
        return dst, (c.frames, c.frame_valid, c.frame_ts, c.start_ts,
                     c.last_seq, c.armed_ts, c.valid, c.origin)

    wide = tuple(f"e{k}" for k in range(9))
    return {
        "app I's shape": case(W, P, 0.45),
        "no free slot": case(W, P, 1.0),
        "more candidates than free slots": case(W, P, 0.9),
        "W = 0": case(0, P, 0.45),
        "P not a multiple of the block": case(3001, 5001, 0.5),
        "more than 32 column jobs": case(W, P, 0.6, wide, wide[:7],
                                         ("i", "j", "k", "l")),
        "an empty table": case(W, P, 0.0),
        "one block": case(300, 1000, 0.6),
    }


def k11b_jobs(case) -> int:
    """Column jobs of a case's insert (chip_smoke's K11b launch formula is
    ceil(jobs / 32) a call, none at W = 0)."""
    dst, (frames, *_rest) = case
    return sum(len(cs) + 2 for r, cs in frames.items()
               if r in dst.frames) + 6


def run_k11b_case(pattern, case, plain: bool):
    """(table, n_drop) after inserting the case's candidates into a copy
    of its table, by the kernel or by the plain version."""
    dst, args = case
    fn = pattern.pending_insert_plain if plain else pattern.pending_insert
    return fn(_pending_clone(dst), *args)


def insert_edge_phase(torch, rng) -> None:
    """K11b's edges against the plain version, the whole table and n_drop
    bit for bit, ceil(jobs / 32) launches a call, the workspace zero after
    every call, app I's shape and two smaller tables alternating."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import pattern
    dev = torch.device("cuda")
    cases = k11b_edge_cases(torch, rng, dev)
    drops = {}
    order = list(cases) + 2 * ["app I's shape", "one block",
                               "P not a multiple of the block"]
    for name in order:
        case = cases[name]
        kernels.reset_launch_counts()
        got, gdrop = run_k11b_case(pattern, case, plain=False)
        W = case[1][-2].shape[0]
        want_launches = -(-k11b_jobs(case) // 32) if W else 0
        if kernels.LAUNCHES["K11b"] != want_launches or \
                kernels.LAUNCHES["K1"]:
            raise Failure(f"K11b edge {name}: {kernels.LAUNCHES['K11b']} "
                          f"launches and {kernels.LAUNCHES['K1']} of K1, "
                          f"{want_launches} and 0 expected")
        want, wdrop = run_k11b_case(pattern, case, plain=True)
        check_equal(f"K11b edge {name} n_drop", gdrop, wdrop)
        for (nm, x), (_, y) in zip(_pending_tensors(got),
                                   _pending_tensors(want)):
            check_equal(f"K11b edge {name} {nm}", x, y)
        ws = kernels.workspace("k11_pattern", 0, dev)
        if int(ws.count_nonzero()):
            raise Failure(f"K11b edge {name}: the workspace is not zero "
                          "after the call")
        drops[name] = int(gdrop)
    if (drops["no free slot"] == 0 or drops["more candidates than free "
                                           "slots"] == 0
            or drops["app I's shape"] or drops["an empty table"]):
        raise Failure(f"K11b edges: drop counts {drops}")
    print(f"K11b edges: {len(cases)} cases bit for bit (tables of three "
          f"sizes alternating after them), ceil(jobs / 32) launches a call, "
          f"the workspace zero; drops {drops}")
    for name in ("more than 32 column jobs", "no free slot"):
        case = cases[name]
        dst = _pending_clone(case[0])
        saved = [x.clone() for _, x in _pending_tensors(dst)]

        def restore(dst=dst, saved=saved):
            for (_, x), x0 in zip(_pending_tensors(dst), saved):
                x.copy_(x0)

        row = dict(ms=device_ms(torch, lambda: pattern.pending_insert(
                       dst, *case[1]), reset=restore),
                   call_ms=time_ms(torch, lambda: pattern.pending_insert(
                       dst, *case[1]), reset=restore))
        print(f"K11b pending_insert {name}: {json.dumps(row)}")


def run_pattern_app(torch, text: str, data, rounds: int = ROUNDS_P,
                    batch: int = BATCH_P, pending: int = PENDING_P,
                    end=None):
    """Feed `rounds` of one A and one B batch (send_columns + flush each),
    then `end(runtime)` if given (a closing heartbeat), and collect
    OutStream's events."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.core import dtypes

    prev = dtypes.config.pattern_pending_capacity
    dtypes.config.pattern_pending_capacity = pending
    try:
        rt = SiddhiManager().create_siddhi_app_runtime(text, batch_size=batch)
    finally:
        dtypes.config.pattern_pending_capacity = prev
    got = []
    rt.add_callback("OutStream", got.extend)
    hs = {s: rt.get_input_handler(f"Stream{s}") for s in ("A", "B")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(rounds):
        sl = slice(r * batch, (r + 1) * batch)
        for side in ("A", "B"):
            val, ts = data[side]
            hs[side].send_columns({"val": val[sl]}, timestamps=ts[sl])
            rt.flush()
    if end is not None:
        end(rt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return rt, got, launches, elapsed, peak


def measure_pattern_steps(torch, rt, data, rounds: int = ROUNDS_P,
                          batch: int = BATCH_P):
    """Both pattern steps alone over the rounds from a fresh state, as
    device batches prepared beforehand, at each step's playback clock;
    (host syncs in one A and one B step, mean ms per round)."""
    from siddhi_tpu_torch.core.event import EventBatch

    qr = rt.query_runtimes["bench"]
    dev = torch.device("cuda")
    nows = pattern_nows(data, rounds, batch)
    steps = []
    for r in range(rounds):
        sl = slice(r * batch, (r + 1) * batch)
        for k, side in enumerate(("A", "B")):
            val, ts = data[side]
            steps.append((qr._steps[f"Stream{side}"], EventBatch.from_numpy(
                ts[sl], {"val": val[sl]}, batch, dev), nows[2 * r + k]))
    qr.state = qr.init_state()

    def first_round():
        for step, b, now in steps[:2]:
            qr.state, _ = step(qr.state, b, now)

    syncs = syncs_in(torch, first_round)
    qr.state = qr.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step, b, now in steps:
        qr.state, _ = step(qr.state, b, now)
    torch.cuda.synchronize()
    return syncs, (time.perf_counter() - t0) / rounds * 1e3


def check_events(name: str, got, want: tuple) -> int:
    """Every output event in order against the oracle's columns (the
    timestamp first, then each attribute)."""
    n = want[0].shape[0]
    if len(got) != n:
        raise Failure(f"app {name}: {len(got)} events out, the oracle "
                      f"expects {n}")
    cols = [np.fromiter((e.timestamp for e in got), np.int64, n)] + [
        np.fromiter((e.data[k] for e in got), np.int64, n)
        for k in range(len(want) - 1)]
    for k, (x, y) in enumerate(zip(cols, want)):
        bad = np.nonzero(x != y)[0]
        if bad.size:
            j = int(bad[0])
            what = "timestamp" if k == 0 else f"attribute {k - 1}"
            raise Failure(f"app {name}: {what} of event {j} is {x[j]}, the "
                          f"oracle says {y[j]}")
    return n


def check_pattern_app(name: str, got, want) -> int:
    """Every output event, in order, against the oracle's (ts, aVal,
    bVal)."""
    return check_events(name, got, want[:3])


def pattern_apps(torch, rng, card: str, summary=None) -> dict:
    """Apps H and I against their oracles, H also through the columnar
    async path when `summary` is given; returns their launches."""
    total = {}
    for name in ("H", "I"):  # one query, two feeds
        data = pattern_events(rng, name)
        check_no_tie(data, ROUNDS_P, BATCH_P)
        want = oracle_pattern(data, ROUNDS_P, BATCH_P, PENDING_P)
        if want[3]:
            raise Failure(f"app {name}: the oracle drops {want[3]} entries")
        rt, got, launches, elapsed, peak = run_pattern_app(torch, APP_H,
                                                           data)
        n = check_pattern_app(name, got, want)
        del got
        dropped = int(rt.query_runtimes["bench"].state.dropped)
        if dropped:
            raise Failure(f"app {name}: {dropped} partial matches dropped")
        for k in ("K1", "K11a", "K7 pattern index", "K11b", "K12a"):
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        if launches["K11b"] != ROUNDS_P:  # one launch an A step's insert
            raise Failure(f"app {name}: {launches['K11b']} K11b launches, "
                          f"{ROUNDS_P} expected")
        syncs, step_ms = measure_pattern_steps(torch, rt, data)
        report_app(name, 2 * BATCH_P * ROUNDS_P, n, elapsed, step_ms, peak,
                   launches, syncs, card, rounds=ROUNDS_P,
                   batch=f"2 x {BATCH_P}")
        if syncs:
            raise Failure(f"app {name}: the pattern step syncs with the "
                          f"host: {syncs}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del rt
        if summary is not None and name == "H":
            sends = []
            for r in range(ROUNDS_P):
                sl = slice(r * BATCH_P, (r + 1) * BATCH_P)
                for side in ("A", "B"):
                    val, ts = data[side]
                    sends.append((f"Stream{side}", {"val": val[sl]}, ts[sl]))
            col = columnar_pair(
                torch, name, APP_H, sends, "OutStream", BATCH_P, ROUNDS_P,
                lambda g, w=want: check_pattern_app("H", g, w), elapsed,
                card, summary, config={"pattern_pending_capacity":
                                       PENDING_P})
            for k, v in col.items():
                total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------- #
# phases 16-17: the absent / every-group kernels (K11c, K11d, K11e), apps O-R
# --------------------------------------------------------------------------- #

# non-occurrence on app I's feed: every A no equal-valued B reaches within
# 5 sec fires at its deadline
APP_O = """
@app:playback
define stream StreamA (val int);
define stream StreamB (val int);
@info(name = 'bench')
from every a=StreamA -> not StreamB[val == a.val] for 5 sec
select a.val as aVal
insert into OutStream;
"""
WAIT_O = 5000
# the mid-pattern `every`: each live A emits every equal-valued B in 5 sec
APP_P = """
@app:playback
define stream StreamA (val int);
define stream StreamB (val int);
@info(name = 'bench')
from every a=StreamA -> every b=StreamB[b.val == a.val] within 5 sec
select a.val as aVal, b.val as bVal
insert into OutStream;
"""
# a sequence across two streams on the merged junction
APP_Q = """
@app:playback
define stream StreamA (val int);
define stream StreamB (val int);
@info(name = 'bench')
from every a=StreamA, b=StreamB[b.val == a.val]
select a.val as aVal, b.val as bVal
insert into OutStream;
"""
ROUNDS_Q = 8
ROWS_Q = 16384  # rows a round, both streams (the taps are per-row host code)
PENDING_Q = 2 * ROWS_Q
VALUES_Q = 4
# the every-group shapes of tests/test_absent_patterns.py (mid group, head
# group), at a small size: no closed-form oracle models the group gate
APPS_R = {
    "R1 mid group": """
@app:playback
define stream S1 (symbol string, price float);
define stream S2 (symbol string, price float);
@info(name = 'bench')
from e4=S1[symbol == 'MSFT'] -> every (e1=S1[price>20.0] -> e3=S1[price>20.0])
  -> e2=S2[price>e1.price]
select e1.price as p1, e3.price as p3, e2.price as p2
insert into OutStream;
""",
    "R2 head group": """
@app:playback
define stream S1 (symbol string, price float);
define stream S2 (symbol string, price float);
@info(name = 'bench')
from every (e1=S1[price>20.0] -> e3=S1[price>20.0]) -> e2=S2[price>e1.price]
select e1.price as p1, e3.price as p3, e2.price as p2
insert into OutStream;
"""}
ROUNDS_R = 8
BATCH_R = 256
def absent_kernel_phase(torch, rng) -> dict:
    """K11c, K11d and K11e against their plain versions at app I's shapes,
    bit for bit, with their timings: K11c and K11d with and without the
    equality pair and the residual tile, K11c with deadlines on both sides
    of the batch's timestamps and without a timer; K11e with many
    completions per origin and completions without one (-1)."""
    from siddhi_tpu_torch.ops import pattern

    dev = torch.device("cuda")
    res = {}
    B, P = BATCH_P, PENDING_P
    t = _pattern_batch(torch, rng, B, P, seq0=5_000_000)
    # deadlines: a third before the batch's first timestamp, a third after
    # its last, the rest inside it
    ts0, ts1 = int(t["ts"][0]), int(t["ts"][-1])
    deadline = torch.from_numpy(rng.integers(ts0 - 3000, ts1 + 3000, P)
                                .astype(np.int64)).to(dev)
    small = {"bval": (t["bval"] % 4).contiguous(),
             "eval": (t["eval"] % 4).contiguous()}

    def resid(p0, p1):
        return (t["bval"][:, None] + t["eval"][None, p0:p1]) % 3 != 0

    seen = {}
    for eq in ("eq", "no eq"):
        # values over 1..4 in the pair, so most live entries meet several
        # arrivals, on both sides of their deadlines
        pairs = [(small["bval"], small["eval"])] if eq == "eq" else []
        for residual in (None, resid):
            for dl in (deadline, None):
                a = (t["arr_seq"], t["ts"], t["lane_ok"], pairs,
                     t["pend_valid"], t["last_seq"], dl)
                what = (f"K11c {eq} {'with' if residual else 'without'} "
                        f"residual {'deadline' if dl is not None else 'untimed'}")
                got = pattern.absent_scan(*a, residual=residual)
                want = pattern.absent_scan_plain(*a, residual=residual)
                for nm, x, y in zip(("first", "before", "after"), got, want):
                    check_equal(f"{what} {nm}", x, y)
                seen[what] = tuple(int(x.sum()) for x in
                                   (got[0] < 2**62, got[1], got[2]))
            a = (t["arr_seq"], t["ts"], t["lane_ok"], pairs,
                 t["pend_valid"], t["last_seq"], t["start_ts"], WITHIN_P)
            what = f"K11d {eq} {'with' if residual else 'without'} residual"
            got = pattern.match_count(*a, residual=residual)
            check_equal(what, got,
                        pattern.match_count_plain(*a, residual=residual))
            seen[what] = int(got)
    print(f"K11c checks (found, before, after) and K11d counts: {seen}")
    if not all(v[1] and v[2] for k, v in seen.items()
               if k.startswith("K11c") and "deadline" in k):
        raise Failure(f"K11c: a case without hits on both sides: {seen}")

    # the path's K11c: app O's B step, the equality and a deadline each side
    a = (t["arr_seq"], t["ts"], t["valid"], [(t["bval"], t["eval"])],
         t["pend_valid"], t["last_seq"], deadline)
    got = pattern.absent_scan(*a)
    res["K11c"] = dict(
        _timed(torch, lambda: pattern.absent_scan(*a),
               lambda: pattern.absent_scan_plain(*a)),
        # lanes: arr_seq, ts, lane_ok, value; entries: valid, last_seq,
        # deadline, value in; first, before, after out
        bound_ms=bound_ms(B * (8 + 8 + 1 + 4) + P * (1 + 8 + 8 + 4)
                          + P * (8 + 1 + 1)),
        max_abs_err=0, bound_by="bytes")
    print(f"K11c absent_scan B={B} P={P} ({int(t['pend_valid'].sum())} live,"
          f" {int(got[1].sum())} before, {int(got[2].sum())} after): "
          f"{res['K11c']}")
    # the path's K11d: app P's sticky count (the equality, within)
    a = (t["arr_seq"], t["ts"], t["valid"], [(t["bval"], t["eval"])],
         t["pend_valid"], t["last_seq"], t["start_ts"], WITHIN_P)
    n = int(pattern.match_count(*a))
    res["K11d"] = dict(
        _timed(torch, lambda: pattern.match_count(*a),
               lambda: pattern.match_count_plain(*a)),
        # lanes: arr_seq, ts, lane_ok, value; entries: valid, last_seq,
        # start_ts, value in; the count out
        bound_ms=bound_ms(B * (8 + 8 + 1 + 4) + P * (1 + 8 + 8 + 4) + 8),
        max_abs_err=0, bound_by="bytes")
    print(f"K11d match_count B={B} P={P} ({n} pairs): {res['K11d']}")

    # K11e: W = P completions (a mid group's end position) into a P-slot
    # head table; origins over a quarter of the slots, 10% -1, 70% valid
    W = P
    valid = torch.from_numpy(rng.random(W) < 0.7).to(dev)
    origin = torch.from_numpy(np.where(
        rng.random(W) < 0.1, -1, rng.integers(0, P // 4, W))
        .astype(np.int32)).to(dev)
    seq = torch.from_numpy(rng.integers(0, 2**40, W)).to(dev)
    ld0 = torch.from_numpy(rng.random((P, 2)) < 0.5).to(dev)
    ls0 = torch.from_numpy(rng.integers(0, 2**40, P)).to(dev)

    def table():
        z = torch.zeros(P, dtype=torch.int64, device=dev)
        return pattern.PendingTable(
            frames={}, frame_valid={}, frame_ts={}, start_ts=z,
            last_seq=ls0.clone(), armed_ts=z,
            valid=torch.ones(P, dtype=torch.bool, device=dev),
            leg_done=ld0.clone(),
            origin=torch.full((P,), -1, dtype=torch.int32, device=dev))

    want = pattern.release_origin_plain(table(), valid, origin, seq)
    work = table()
    got = pattern.release_origin(work, valid, origin, seq)
    check_equal("K11e leg_done", got.leg_done, want.leg_done)
    check_equal("K11e last_seq", got.last_seq, want.last_seq)
    hit = origin[valid & (origin >= 0)].long()
    n_orig = int(torch.unique(hit).numel())
    per = torch.bincount(hit, minlength=P)
    if int(per.max()) < 2:
        raise Failure("K11e: no origin with several completions")

    def restore():
        work.leg_done.copy_(ld0)
        work.last_seq.copy_(ls0)

    def library():
        o = torch.where(valid & (origin >= 0), origin.long(), P)
        ls = torch.cat([work.last_seq, work.last_seq.new_zeros(1)])
        ls.scatter_reduce_(0, o, seq, "amax")
        ld = torch.cat([work.leg_done[:, 0], valid.new_zeros(1)])
        ld.index_put_((o,), valid.new_zeros(()))

    res["K11e"] = dict(
        _timed(torch, lambda: pattern.release_origin(work, valid, origin,
                                                     seq),
               lambda: pattern.release_origin_plain(work, valid, origin,
                                                    seq),
               library=library, reset=restore),
        # per completion valid, origin, seq read; per origin its latch
        # byte and seq written
        bound_ms=bound_ms(W * (1 + 4 + 8) + n_orig * (1 + 8)),
        max_abs_err=0, bound_by="bytes")
    print(f"K11e release_origin W={W} into P={P} ({n_orig} origins, at most "
          f"{int(per.max())} completions each): {res['K11e']}")
    torch.cuda.synchronize()
    return res


def oracle_absent(data, rounds: int, batch: int, pending: int,
                  wait: int = WAIT_O, end=None):
    """App O step by step on a model of position 1's table: an A batch's
    arrivals take the free slots in ascending order, then every live entry
    whose deadline (its ts + wait) the step's clock has passed fires at its
    deadline, in slot order; a B batch first kills each live entry that an
    equal value reaches before its deadline, then fires the same way; a
    final heartbeat at `end` fires the rest. Returns (ts, aVal) arrays and
    the dropped count."""
    (va, ta), (vb, tb) = data["A"], data["B"]
    live = np.zeros(pending, bool)
    sval = np.zeros(pending, np.int64)
    sts = np.zeros(pending, np.int64)
    out_ts, out_a = [], []
    dropped = 0

    def fire(now):
        slots = np.flatnonzero(live & (now >= sts + wait))
        out_ts.append(sts[slots] + wait)
        out_a.append(sval[slots])
        live[slots] = False

    nows = iter(pattern_nows(data, rounds, batch))
    hi = int(max(va.max(), vb.max())) + 1
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        free = np.flatnonzero(~live)
        k = min(free.size, batch)
        dropped += batch - k
        live[free[:k]] = True
        sval[free[:k]] = va[s][:k]
        sts[free[:k]] = ta[s][:k]
        fire(next(nows))
        first_b = np.full(hi, 2**62, np.int64)
        np.minimum.at(first_b, vb[s], tb[s])
        live &= ~(first_b[sval] < sts + wait)
        fire(next(nows))
    fire(end if end is not None else 2**61)
    return np.concatenate(out_ts), np.concatenate(out_a), dropped


def oracle_sticky(data, rounds: int, batch: int, pending: int,
                  within: int = WITHIN_P, passes: int = 4):
    """App P step by step on the table model: entries expire when the
    step's clock is more than `within` past their A; an A batch takes the
    free slots; on a B batch, pass k emits for every live entry its k-th
    equal-valued B within `within` (pass-major, slot order within a pass)
    and the ones past `passes` count as dropped. Returns (ts, aVal, bVal)
    arrays and the dropped count."""
    (va, ta), (vb, tb) = data["A"], data["B"]
    live = np.zeros(pending, bool)
    sval = np.zeros(pending, np.int64)
    sts = np.zeros(pending, np.int64)
    out_ts, out_a, out_b = [], [], []
    dropped = 0
    nows = iter(pattern_nows(data, rounds, batch))
    shift = np.int64(2**32)
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        live &= next(nows) - sts <= within
        free = np.flatnonzero(~live)
        k = min(free.size, batch)
        dropped += batch - k
        live[free[:k]] = True
        sval[free[:k]] = va[s][:k]
        sts[free[:k]] = ta[s][:k]
        live &= next(nows) - sts <= within
        bv, bt = vb[s].astype(np.int64), tb[s]
        # lanes by (value, lane); B timestamps rise with the lane, so the
        # lanes of one value inside `within` of an entry are a prefix
        order = np.argsort(bv, kind="stable")
        key = bv[order] * shift + (bt[order] - bt.min())
        slots = np.flatnonzero(live)
        lo = np.searchsorted(key, sval[slots] * shift, side="left")
        hi = np.searchsorted(key, sval[slots] * shift
                             + (sts[slots] + within - bt.min()), side="right")
        cnt = np.maximum(hi - lo, 0)
        dropped += int(np.maximum(cnt - passes, 0).sum())
        for p in range(passes):
            m = cnt > p
            lane = order[lo[m] + p]
            out_ts.append(bt[lane])
            out_a.append(sval[slots[m]])
            out_b.append(bv[lane])
    cat = np.concatenate
    return cat(out_ts), cat(out_a), cat(out_b), dropped


def sequence_feed(rng, rounds: int = ROUNDS_Q, rows: int = ROWS_Q):
    """App Q's feed in send order: a stream per row (A or B with equal
    odds), values uniform over 1..VALUES_Q, 1 ms apart."""
    n = rounds * rows
    is_a = rng.random(n) < 0.5
    val = rng.integers(1, VALUES_Q + 1, n).astype(np.int32)
    return is_a, val, np.arange(n, dtype=np.int64) + 1000


def oracle_sequence(is_a, val, ts, rounds: int = ROUNDS_Q,
                    rows: int = ROWS_Q):
    """App Q on the table model: each A (a row followed by an equal-valued
    B) matches its next row in send order. A merged batch (one round)
    inserts its A rows into the free slots in ascending order (the A on a
    round's last row stays, in its slot, for the next round's first row)
    and emits its matches in slot order. Returns (ts, aVal, bVal)."""
    out = []
    carry = None  # (slot, value) of a round's last-row A
    for r in range(rounds):
        s = slice(r * rows, (r + 1) * rows)
        a, v, t = is_a[s], val[s], ts[s]
        lanes = np.flatnonzero(a)
        free = np.arange(lanes.size + 1)
        if carry is not None:
            free = free[free != carry[0]]
        slot = free[:lanes.size]
        hits = []
        if carry is not None and not a[0] and v[0] == carry[1]:
            hits.append((carry[0], carry[1], v[0], t[0]))
        nxt = lanes + 1
        inside = nxt < rows
        ok = np.zeros(lanes.size, bool)
        ok[inside] = ~a[nxt[inside]] & (v[nxt[inside]] == v[lanes[inside]])
        for k in np.flatnonzero(ok):
            hits.append((slot[k], v[lanes[k]], v[nxt[k]], t[nxt[k]]))
        hits.sort()
        out += hits
        carry = (int(slot[-1]), v[-1]) if a[-1] else None
    arr = np.array([(h[3], h[1], h[2]) for h in out], np.int64).reshape(-1, 3)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def absent_every_apps(torch, rng, card: str) -> dict:
    """Apps O, P and Q against their oracles and R on the card against the
    CPU; each reads its own launch counts; returns their launches."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.pattern_runtime import MERGED_SID

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    data = pattern_events(rng, "I", ROUNDS_P, BATCH_P)
    check_no_tie(data, ROUNDS_P, BATCH_P)
    end = int(data["B"][1].max()) + WAIT_O + 1
    for name, text, on_path in (("O", APP_O, ("K1", "K7 pattern index",
                                              "K11b", "K11c", "K12a")),
                                ("P", APP_P, ("K1", "K11a",
                                              "K7 pattern index", "K11b",
                                              "K11d", "K12a"))):
        if name == "O":
            want = oracle_absent(data, ROUNDS_P, BATCH_P, PENDING_P, end=end)
        else:
            want = oracle_sticky(data, ROUNDS_P, BATCH_P, PENDING_P)
        if name == "O" and want[-1]:
            raise Failure(f"app O: the oracle drops {want[-1]} entries")
        rt, got, launches, elapsed, peak = run_pattern_app(
            torch, text, data, ROUNDS_P, BATCH_P, PENDING_P,
            end=(lambda r: r.heartbeat(end)) if name == "O" else None)
        n = check_events(name, got, want[:-1])
        del got
        dropped = int(rt.query_runtimes["bench"].state.dropped)
        rt.collect_overflow()
        stats = rt.ctx.statistics.overflow.get(
            "query:bench.pattern_pending_dropped", 0)
        if dropped != want[-1] or stats != want[-1]:
            raise Failure(f"app {name}: {dropped} dropped ({stats} in "
                          f"Statistics.overflow), the oracle says "
                          f"{want[-1]}")
        for k in on_path:
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        # one index a B step (one equality column), shared by P's four
        # sticky K11a passes and its K11d count
        if launches["K7 pattern index"] != ROUNDS_P:
            raise Failure(f"app {name}: {launches['K7 pattern index']} "
                          f"index sorts in {ROUNDS_P} B steps, one a step "
                          "expected")
        syncs, step_ms = measure_pattern_steps(torch, rt, data, ROUNDS_P,
                                               BATCH_P)
        report_app(name, 2 * BATCH_P * ROUNDS_P, n, elapsed, step_ms, peak,
                   launches, syncs, card, rounds=ROUNDS_P,
                   batch=f"2 x {BATCH_P}")
        print(f"app {name}: dropped {dropped} (oracle {want[-1]})")
        if syncs:
            raise Failure(f"app {name}: the pattern step syncs with the "
                          f"host: {syncs}")
        add(launches)
        del rt

    # app Q: the merged junction in send order, runs of one stream sent
    # by send_columns
    is_a, val, ts = sequence_feed(rng, ROUNDS_Q, ROWS_Q)
    want = oracle_sequence(is_a, val, ts, ROUNDS_Q, ROWS_Q)
    rt = make_runtime(APP_Q, BATCH_P,
                      config={"pattern_pending_capacity": PENDING_Q})
    got = []
    rt.add_callback("OutStream", got.extend)
    hs = {True: rt.get_input_handler("StreamA"),
          False: rt.get_input_handler("StreamB")}
    cuts = np.flatnonzero(np.diff(is_a.astype(np.int8))) + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(ROUNDS_Q):
        lo, hi = r * ROWS_Q, (r + 1) * ROWS_Q
        edges = [lo, *cuts[(cuts > lo) & (cuts < hi)].tolist(), hi]
        for a, b in zip(edges[:-1], edges[1:]):
            hs[bool(is_a[a])].send_columns({"val": val[a:b]},
                                           timestamps=ts[a:b])
        rt.flush()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n = check_events("Q", got, want)
    for k in ("K1", "K11a", "K11b", "K12a"):
        if launches[k] == 0:
            raise Failure(f"app Q: kernel {k} never launched")
    qr = rt.query_runtimes["bench"]
    mj = qr.merged_junction
    batches = []
    for r in range(ROUNDS_Q):
        s = slice(r * ROWS_Q, (r + 1) * ROWS_Q)
        cols = {"_tag": np.where(is_a[s], 0, 1).astype(np.int32),
                "StreamA::val": np.where(is_a[s], val[s], 0).astype(np.int32),
                "StreamB::val": np.where(is_a[s], 0, val[s]).astype(np.int32)}
        batches.append(EventBatch.from_numpy(ts[s], cols, ROWS_Q,
                                             mj.ctx.device))
    step = qr._steps[MERGED_SID]
    qr.state = qr.init_state()
    syncs = syncs_in(torch, lambda: setattr(qr, "state", step(
        qr.state, batches[0], int(ts[ROWS_Q - 1]))[0]))
    qr.state = qr.init_state()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for r, b in enumerate(batches):
        qr.state, _ = step(qr.state, b, int(ts[(r + 1) * ROWS_Q - 1]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / ROUNDS_Q * 1e3
    report_app("Q", ROUNDS_Q * ROWS_Q, n, elapsed, step_ms, peak, launches,
               syncs, card, rounds=ROUNDS_Q, batch=ROWS_Q)
    if syncs:
        raise Failure(f"app Q: the sequence step syncs with the host: "
                      f"{syncs}")
    add(launches)
    del rt, got

    # apps R: the group shapes, the card against the CPU
    pool = np.array(["MSFT", "WSO2", "GOOG", "IBM", "ORCL"], dtype=object)
    n1, n2 = BATCH_R, BATCH_R // 4
    feed = []
    for r in range(ROUNDS_R):
        t = 1000 + 400 * r
        feed.append(("S1", {"symbol": pool[rng.choice(
            5, n1, p=[0.02, 0.245, 0.245, 0.245, 0.245])],
            "price": rng.uniform(10, 60, n1).astype(np.float32)},
            t + np.arange(n1)))
        feed.append(("S2", {"symbol": pool[rng.integers(0, 5, n2)],
                            "price": rng.uniform(10, 70, n2).astype(
                                np.float32)}, t + n1 + np.arange(n2)))
    for name, text in APPS_R.items():
        outs, syncs = {}, []
        for dev in ("cuda", "cpu"):
            rt = SiddhiManager(device=dev).create_siddhi_app_runtime(
                text, batch_size=BATCH_R)
            got = []
            rt.add_callback("OutStream", lambda evs, g=got: g.extend(
                (e.timestamp, tuple(e.data)) for e in evs))
            kernels.reset_launch_counts()
            for sid, cols, tss in feed:
                rt.get_input_handler(sid).send_columns(cols, timestamps=tss)
                rt.flush()
            outs[dev] = (got, int(rt.query_runtimes["bench"].state.dropped))
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                qr = rt.query_runtimes["bench"]
                j = rt.junctions["S1"]
                sid, cols, tss = feed[0]
                b = EventBatch.from_numpy(
                    tss, j.codec.encode_columns(cols, n1), n1, j.ctx.device)
                syncs = syncs_in(torch, lambda: setattr(qr, "state", qr._steps[
                    "S1"](qr.state, b, int(tss[-1]))[0]))
            del rt
        if outs["cuda"] != outs["cpu"]:
            raise Failure(f"app {name}: the card and the CPU differ")
        n_out = len(outs["cuda"][0])
        if n_out == 0:
            raise Failure(f"app {name}: no event out")
        need = ("K11a", "K11b", "K11e") if "mid" in name else ("K11a",
                                                              "K11b")
        for k in need:
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        print(f"app {name}: {ROUNDS_R * (n1 + n2)} events in, {n_out} out, "
              f"the card and the CPU agree in order (dropped "
              f"{outs['cuda'][1]}); kernel launches "
              f"{ {k: v for k, v in launches.items() if v} }; host syncs "
              f"in one step: {len(syncs)} {syncs} [{card}]")
        if syncs:
            raise Failure(f"app {name}: the pattern step syncs with the "
                          f"host: {syncs}")
        add(launches)
    return total


# --------------------------------------------------------------------------- #
# phases 12-13: the aggregator kernels (K8, K9 HLL) and apps J-M
# --------------------------------------------------------------------------- #


def _hll_hash_np(codes: np.ndarray) -> np.ndarray:
    """K3's hash of one int32 column, then murmur3's fmix64, in uint64."""
    with np.errstate(over="ignore"):
        x = codes.astype(np.int64).view(np.uint64)
        h = (np.uint64(0xCBF29CE484222325) ^ x) * np.uint64(0x100000001B3)
        h ^= h >> np.uint64(29)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xC4CEB9FE1A85EC53)
        h ^= h >> np.uint64(33)
    return h


def _hll_estimate_np(regs: np.ndarray) -> int:
    """The harmonic-mean estimate with linear counting, in float32."""
    m = regs.shape[0]
    R = regs.astype(np.float32)
    inv = np.exp2(-R).sum(dtype=np.float32)
    E = np.float32(0.7213 / (1.0 + 1.079 / m) * m * m) / inv
    zeros = int((R == 0).sum())
    if E <= 2.5 * m and zeros > 0:
        E = np.float32(m) * np.log(np.float32(m) / np.float32(zeros))
    return int(np.rint(E))


def oracle_j(sym: np.ndarray, rounds: int, batch: int) -> np.ndarray:
    """Per event, the sketch's estimate after its round: the string codes
    in first-seen order (1, 2, ...), K3's hash and fmix64, register
    j = h & (m - 1) and rank = clz32 of (h >> log2 m) + 1, max-updated."""
    _, first, inv = np.unique(sym, return_index=True, return_inverse=True)
    rank = np.empty_like(first)
    rank[np.argsort(first)] = np.arange(first.shape[0])
    h = _hll_hash_np((rank[inv] + 1).astype(np.int32))
    p = HLL_M.bit_length() - 1
    j = (h & np.uint64(HLL_M - 1)).astype(np.int64)
    w = ((h >> np.uint64(p)) & np.uint64(0xFFFFFFFF)).astype(np.float64)
    rho = 33 - np.frexp(w)[1]
    regs = np.zeros(HLL_M, np.int64)
    out = np.empty(rounds * batch, np.int64)
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        np.maximum.at(regs, j[s], rho[s])
        out[s] = _hll_estimate_np(regs)
    return out


def check_j(got, sym, ts, rounds: int, batch: int) -> int:
    """Every estimate within max(1, 1e-5 E) of the numpy sketch, and each
    round's within 3 standard errors (1.04 / sqrt(m) each) of the exact
    count of symbols seen so far."""
    n = ts.shape[0]
    if len(got) != n:
        raise Failure(f"app J: {len(got)} events out, expected {n}")
    if not np.array_equal(np.fromiter((e.timestamp for e in got), np.int64,
                                      n), ts):
        raise Failure("app J: timestamps differ from the oracle")
    g = np.fromiter((e.data[0] for e in got), np.int64, n)
    want = oracle_j(sym, rounds, batch)
    bad = np.abs(g - want) > np.maximum(1, 1e-5 * want)
    if bad.any():
        i = int(np.argmax(bad))
        raise Failure(f"app J: estimate of event {i} is {g[i]}, the sketch "
                      f"model says {want[i]}")
    sigma3 = 3 * 1.04 / np.sqrt(HLL_M)
    for r in range(rounds):
        exact = np.unique(sym[:(r + 1) * batch]).shape[0]
        est = g[(r + 1) * batch - 1]
        if abs(est - exact) > sigma3 * exact:
            raise Failure(f"app J: round {r} estimates {est} distinct "
                          f"symbols, {exact} were seen")
    return n


def _rmq(vals: np.ndarray, lo: np.ndarray, hi: np.ndarray, op) -> np.ndarray:
    """op over vals[lo[i]..hi[i]] (inclusive, lo <= hi) by a sparse table."""
    levels = [vals]
    span = 1
    while 2 * span <= vals.shape[0]:
        prev = levels[-1]
        levels.append(np.concatenate([op(prev[:-span], prev[span:]),
                                      prev[-span:]]))
        span *= 2
    k = np.frexp((hi - lo + 1).astype(np.float64))[1] - 1
    out = np.empty(lo.shape[0], vals.dtype)
    for lvl in np.unique(k):
        m = k == lvl
        t = levels[lvl]
        out[m] = op(t[lo[m]], t[hi[m] - (1 << int(lvl)) + 1])
    return out


def oracle_k(sym: np.ndarray, price32: np.ndarray, span: int):
    """Per event, the max and min price of its symbol over the last `span`
    events (ms, 1 ms apart), inclusive."""
    n = sym.shape[0]
    idx = np.arange(n, dtype=np.int64)
    order = np.lexsort((idx, sym))
    ks = sym[order].astype(np.int64)
    comb = ks * n + idx[order]
    lo = np.maximum(np.searchsorted(comb, comb - span + 1, side="left"),
                    np.searchsorted(comb, ks * n, side="left"))
    q = np.arange(n)
    vals = price32[order]
    hi_o = np.empty(n, np.float32)
    lo_o = np.empty(n, np.float32)
    hi_o[order] = _rmq(vals, lo, q, np.maximum)
    lo_o[order] = _rmq(vals, lo, q, np.minimum)
    return hi_o, lo_o


def oracle_l(price32: np.ndarray, volume: np.ndarray, length: int):
    """Per event, max(price) and min(volume) over the last `length` events
    inclusive, and the running max of price (maxForever)."""
    n = price32.shape[0]
    q = np.arange(n)
    lo = np.maximum(q - length + 1, 0)
    return (_rmq(price32, lo, q, np.maximum),
            _rmq(volume, lo, q, np.minimum),
            np.maximum.accumulate(price32))


def _seg_scan(v: np.ndarray, start: np.ndarray, op) -> np.ndarray:
    """Inclusive scan under op restarting at each segment start."""
    s, f = v.copy(), start.copy()
    off = 1
    while off < s.shape[0]:
        s[off:] = np.where(f[off:], s[off:], op(s[:-off], s[off:]))
        f[off:] = f[off:] | f[:-off]
        off *= 2
    return s


def oracle_m(sym: np.ndarray, price32: np.ndarray, ts: np.ndarray,
             period: int):
    """Events of every flushed bucket (the last bucket stays open), in
    order, with the running max, min, mean, population standard deviation
    (float64) and count of their symbol within the bucket."""
    bucket = (ts - ts[0]) // period
    sel = np.nonzero(bucket < bucket[-1])[0]
    key = bucket[sel] * (int(sym.max()) + 1) + sym[sel]
    order = np.lexsort((sel, key))
    ks = key[order]
    start = np.r_[True, ks[1:] != ks[:-1]]
    seg = np.cumsum(start) - 1
    v32 = price32[sel][order]
    v = v32.astype(np.float64)

    def running_sum(x):
        cs = np.cumsum(x)
        return cs - (cs - x)[start][seg]

    pos = np.arange(order.shape[0])
    cnt = pos - pos[start][seg] + 1
    total, sumsq = running_sum(v), running_sum(v * v)
    mean = total / cnt
    sd = np.sqrt(np.maximum(sumsq / cnt - mean * mean, 0.0))
    out = {}
    for name, vals in (("high", _seg_scan(v32, start, np.maximum)),
                       ("low", _seg_scan(v32, start, np.minimum)),
                       ("avgPrice", mean), ("sd", sd), ("n", cnt)):
        col = np.empty_like(vals)
        col[order] = vals
        out[name] = col
    return sel, out


def check_m(got, sym, price32, ts, period: int, pool) -> int:
    """max, min and count exact; avg rtol 1e-5; sd within 1e-4 sd plus
    sqrt(4 eps32 mean^2), the float32 cancellation of sumsq/n - mean^2."""
    sel, want = oracle_m(sym, price32, ts, period)
    n = sel.shape[0]
    if len(got) != n:
        raise Failure(f"app M: {len(got)} events out, oracle expects {n}")
    if not np.array_equal(np.fromiter((e.timestamp for e in got), np.int64,
                                      n), ts[sel]):
        raise Failure("app M: timestamps differ from the oracle")
    if [e.data[0] for e in got] != pool[sym[sel]].tolist():
        raise Failure("app M: symbols differ from the oracle")
    eps32 = float(np.finfo(np.float32).eps)
    for i, name in enumerate(("high", "low", "avgPrice", "sd", "n"), 1):
        g = np.fromiter((e.data[i] for e in got), np.float64, n)
        w = want[name]
        if name == "avgPrice":
            ok = np.abs(g - w) <= RTOL * np.abs(w)
        elif name == "sd":
            ok = np.abs(g - w) <= (1e-4 * w + np.sqrt(
                4 * eps32 * want["avgPrice"] ** 2))
        else:
            ok = g == w
        if not ok.all():
            j = int(np.argmin(ok))
            raise Failure(f"app M: {name} of event {j} is {g[j]}, the "
                          f"oracle says {w[j]}")
    return n


def _sliding_chunk(torch, rng, B: int, kind: str):
    """A sliding window's chunk of E = B expired + B current lanes: at a
    length window's steady state each arrival follows the eviction it
    causes ("steady"), or only expirations with no arrival ("expiring")."""
    from siddhi_tpu_torch.core.event import EventBatch

    dev = torch.device("cuda")
    L = 2 * B
    if kind == "steady":
        types = np.tile(np.array([1, 0], np.int8), B)
        valid = np.ones(L, bool)
        valid[L - 2000:] = rng.random(2000) < 0.5
    else:
        types = np.ones(L, np.int8)
        valid = np.arange(L) < B // 2
    return EventBatch(ts=torch.zeros(L, dtype=torch.int64, device=dev),
                      cols={}, valid=torch.from_numpy(valid).to(dev),
                      types=torch.from_numpy(types).to(dev))


def aggregator_kernel_phase(torch, rng, B: int = BATCH) -> dict:
    """K8 (ungrouped and grouped) and K9 HLL against their plain versions
    at apps J, K and L's shapes (C = B ring rows, L = 2B chunk lanes), and
    an int32 min through K5b; with their timings."""
    from siddhi_tpu_torch.ops import aggregators as ag
    from siddhi_tpu_torch.ops import extrema as ex
    from siddhi_tpu_torch.ops import groupby

    dev = torch.device("cuda")
    res = {}
    C, L = B, 2 * B
    winlen0 = min(LENGTH_D, C - 1000)
    # the expiry frontier is not a multiple of C: the ring wraps
    expired = torch.tensor(1_000_003, device=dev)
    appended = expired + winlen0
    steady = _sliding_chunk(torch, rng, B, "steady")
    expiring = _sliding_chunk(torch, rng, B, "expiring")

    def values(dt, n, nan=False):
        if dt == torch.float32:
            v = rng.uniform(1, 100, n).astype(np.float32)
            if nan:
                v[rng.choice(n, 5, replace=False)] = np.nan
        else:
            v = rng.integers(-(2**40), 2**40, n)
        return torch.from_numpy(v).to(dev).to(dt)

    # K8 ungrouped: f32 max over a wrapped ring (app L's steady chunk),
    # int64 min over a chunk with no CURRENT lane, f32 max with NaN
    cases = [("max", torch.float32, steady, False),
             ("min", torch.int64, expiring, False),
             ("max", torch.float32, steady, True)]
    for op, dt, chunk, nan in cases:
        rv, cv = values(dt, C, nan), values(dt, L, nan)
        check_equal(f"K8 {op} {dt} nan={nan}",
                    ex.sliding_extrema_lanes(op, rv, expired, appended,
                                             chunk, cv),
                    ex.sliding_extrema_lanes_plain(op, rv, expired, appended,
                                                   chunk, cv))
    rv, cv = values(torch.float32, C), values(torch.float32, L)
    res["K8"] = dict(
        _timed(torch,
               lambda: ex.sliding_extrema_lanes("max", rv, expired, appended,
                                                steady, cv),
               lambda: ex.sliding_extrema_lanes_plain(
                   "max", rv, expired, appended, steady, cv)),
        # ring values, chunk values, valid and types in; results out
        bound_ms=bound_ms(C * 4 + L * (4 + 1 + 1) + L * 4), max_abs_err=0,
        bound_by="bytes")
    print(f"K8 sliding_extrema_lanes C={C} L={L}: {res['K8']}")

    # K8 grouped: 1,000 and 1,000,000 groups, hashed as the runtime does
    for n_groups in (E_SYMBOLS, N_KEYS):
        gid = torch.from_numpy(rng.integers(0, n_groups, C + L)).to(dev)
        rk = groupby.hash_columns([gid[:C]])
        ck = groupby.hash_columns([gid[C:]])
        for op in ("max", "min"):
            check_equal(
                f"K8 grouped {op} groups={n_groups}",
                ex.grouped_sliding_extrema_lanes(op, rv, rk, expired,
                                                 appended, steady, cv, ck),
                ex.grouped_sliding_extrema_lanes_plain(
                    op, rv, rk, expired, appended, steady, cv, ck))
        if n_groups == E_SYMBOLS:
            res["K8 grouped"] = dict(
                _timed(torch,
                       lambda: ex.grouped_sliding_extrema_lanes(
                           "max", rv, rk, expired, appended, steady, cv, ck),
                       lambda: ex.grouped_sliding_extrema_lanes_plain(
                           "max", rv, rk, expired, appended, steady, cv,
                           ck)),
                # as K8, plus the ring's and the lanes' group hashes
                bound_ms=bound_ms(C * (4 + 8) + L * (4 + 8 + 1 + 1)
                                  + L * 4),
                max_abs_err=0, bound_by="bytes")
    print(f"K8 grouped_sliding_extrema_lanes C={C} L={L} groups="
          f"{E_SYMBOLS}: {res['K8 grouped']}")

    # K9 HLL at app J's chunk: string codes of 100,000 symbols, EXPIRED
    # lanes ignored; ungrouped and grouped past G = 4096, 0, 1 and 3 resets
    M, G = HLL_M, 4096
    codes = torch.from_numpy(rng.integers(1, C_SYMBOLS, L).astype(
        np.int32)).to(dev)
    h = groupby.hash_columns([codes])
    sign = torch.where(steady.types == 1, -1, 1).to(torch.int32)
    est_err = 0
    for grouped in (False, True):
        g = G if grouped else 1
        slots = (torch.from_numpy(rng.integers(0, G + 64, L).astype(
            np.int32)).to(dev) if grouped
            else torch.zeros(L, dtype=torch.int32, device=dev))
        regs0, drop0, _ = ag.hll_scan_plain(
            torch.zeros(g * M, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev), slots,
            groupby.hash_columns([codes + 7]), sign, steady.valid,
            torch.zeros(L, dtype=torch.bool, device=dev), M)
        for n_res in (0, 1, 3):
            resets = torch.zeros(L, dtype=torch.bool, device=dev)
            resets[torch.from_numpy(rng.choice(L, n_res, replace=False)).to(
                dev)] = True
            lane_valid = steady.valid & ~resets
            pr, pd, pe = ag.hll_scan_plain(regs0.clone(), drop0.clone(),
                                           slots, h, sign, lane_valid,
                                           resets, M)
            kr, kd, ke = ag.hll_scan(regs0.clone(), drop0.clone(), slots, h,
                                     sign, lane_valid, resets, M)
            name = f"K9 HLL grouped={grouped} resets={n_res}"
            check_equal(f"{name} registers", kr, pr)
            check_equal(f"{name} dropped", kd, pd)
            d = (ke - pe).abs()
            if bool((d > torch.clamp(pe.double() * 1e-5, min=1)).any()):
                raise Failure(f"{name}: estimates off by up to "
                              f"{int(d.max())}")
            est_err = max(est_err, int(d.max()))
    # timings at app J's path: ungrouped, no reset
    slots = torch.zeros(L, dtype=torch.int32, device=dev)
    no_res = torch.zeros(L, dtype=torch.bool, device=dev)
    regs = torch.zeros(M, dtype=torch.int32, device=dev)
    drop = torch.zeros((), dtype=torch.int64, device=dev)

    def restore():
        regs.zero_()
        drop.zero_()

    res["K9 HLL"] = dict(
        _timed(torch,
               lambda: ag.hll_update_cuda(regs, drop, slots, h, sign,
                                          steady.valid, no_res, M),
               lambda: ag.hll_registers_plain(regs, drop, slots, h, sign,
                                              steady.valid, no_res, M),
               reset=restore),
        # hashes, slots, signs, valid and reset flags in; the one group's
        # registers read and written
        bound_ms=bound_ms(L * (8 + 4 + 4 + 1 + 1) + 2 * M * 4),
        max_abs_err=0, bound_by="bytes")
    pending = ag.hll_update_cuda(regs, drop, slots, h, sign, steady.valid,
                                 no_res, M)
    res["K9 HLL estimate"] = dict(
        _timed(torch,
               lambda: ag.hll_estimate_cuda(regs, slots, pending, M),
               lambda: ag.hll_estimate_plain(regs, M)[slots.long()]),
        # slots and the group's registers in; estimates out
        bound_ms=bound_ms(L * 4 + M * 4 + L * 8), max_abs_err=est_err,
        bound_by="bytes")
    for k in ("K9 HLL", "K9 HLL estimate"):
        print(f"{k} L={L} M={M}: {res[k]}")

    # K5b's int32 instantiation (min/max over an int attribute in a batch
    # window), bit for bit
    K = GROUP_CAP
    slots = torch.from_numpy(rng.integers(0, K, L).astype(np.int32)).to(dev)
    d = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, L).astype(
        np.int32)).to(dev)
    resets = torch.zeros(L, dtype=torch.bool, device=dev)
    resets[L // 3] = True
    cur = torch.tensor(5, dtype=torch.int32, device=dev)
    for op in ("min", "max"):
        st0 = groupby.init_group_state(K, torch.int32, dev)
        ks, ko = groupby.grouped_scan(st0, slots, d, steady.valid, resets,
                                      cur, op)
        ps, po = groupby.grouped_scan_plain(
            groupby.init_group_state(K, torch.int32, dev), slots, d,
            steady.valid, resets, cur, op)
        for nm, a, b in (("values", ks.values, ps.values),
                         ("epoch", ks.epoch, ps.epoch), ("out", ko, po)):
            check_equal(f"K5b grouped {op} int32 {nm}", a, b)
    print("K5b grouped_scan int32 min/max: bit for bit")
    torch.cuda.synchronize()
    return res


def agg_events(rng, n_symbols: int, rounds: int, batch: int):
    """symbol index uniform over n_symbols, price 1-100, volume 1-999,
    timestamps 1 ms apart."""
    n = rounds * batch
    sym = rng.integers(0, n_symbols, n)
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return sym, price, volume, ts


def _time_text(ms: int) -> str:
    return f"{ms // 1000} sec" if ms % 1000 == 0 else f"{ms} millisec"


def agg_apps_plan(sizes: dict) -> dict:
    """app -> (text, symbols, on-path kernels) at the given window sizes."""
    k2b = ("K2b pack", "K2b fetch", "K2b append", "K2b gather")
    return {
        "J": (APP_J.format(_time_text(sizes["J"])), C_SYMBOLS,
              ("K1", *k2b, "K3", "K9 HLL", "K9 HLL estimate", "K6",
               "K7 merge")),
        "K": (APP_K.format(_time_text(sizes["K"])), E_SYMBOLS,
              ("K1", *k2b, "K3", "K8 grouped", "K6", "K7 merge")),
        "L": (APP_L.format(sizes["L"]), E_SYMBOLS,
              ("K1", *k2b, "K8", "K5b ungrouped", "K7 merge")),
        "M": (APP_M.format(_time_text(sizes["M"])), M_SYMBOLS,
              ("K1", "K5", "K5b grouped", "K6", "K7 merge", "K7 K5 sort",
               "K7 K5b sort")),
    }


def expect_agg_app(name: str, sym, price, volume, ts, window: int,
                   rounds: int, batch: int, pool):
    """The oracle's check of app `name`: a function of its events."""
    price32 = price.astype(np.float32)
    if name == "J":
        return lambda got: check_j(got, sym, ts, rounds, batch)
    if name == "K":
        hi, lo = oracle_k(sym, price32, window)
        cols = [("symbol", pool[sym].tolist(), False),
                ("high", hi, "exact"), ("low", lo, "exact")]
    elif name == "L":
        hi, lo, top = oracle_l(price32, volume, window)
        cols = [("hi", hi, "exact"), ("lo", lo, False),
                ("top", top, "exact")]
    else:
        return lambda got: check_m(got, sym, price32, ts, window, pool)
    return lambda got: check_sliding(name, got, ts, cols)


def aggregator_apps(torch, rng, card: str, rounds: int = ROUNDS,
                    batch: int = BATCH, sizes: dict = None) -> dict:
    """Apps J, K, L and M against their oracles; returns their launches."""
    sizes = sizes or AGG_SIZES
    total = {}
    for name, (text, n_sym, on_path) in agg_apps_plan(sizes).items():
        sym, price, volume, ts = agg_events(rng, n_sym, rounds, batch)
        pool = symbols(n_sym)
        columns = {"symbol": pool[sym], "price": price, "volume": volume}
        check = expect_agg_app(name, sym, price, volume, ts, sizes[name],
                               rounds, batch, pool)
        rt, got, launches, elapsed, peak = run_app(
            torch, text, columns, ts, out_stream="OutStream", rounds=rounds,
            batch=batch)
        n_out = check(got)
        del got
        for k in on_path + ("K12a",):
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        syncs, step_ms = measure_steps(torch, rt, columns, ts, fresh=True,
                                       rounds=rounds, batch=batch)
        report_app(name, ts.shape[0], n_out, elapsed, step_ms, peak,
                   launches, syncs, card, rounds=rounds, batch=batch)
        if syncs:
            raise Failure(f"app {name}: the step syncs with the host: "
                          f"{syncs}")
        del rt
    return total


# --------------------------------------------------------------------------- #
# phases 14-15: the wire pack (K12a), app N and the columnar async path
# --------------------------------------------------------------------------- #

#: output schemas K12a is held at: app A's (code, 2 x float32), app G's join
#: output (int key, 2 x float32) and app N's (code, float32)
WIRE_SCHEMAS = {
    "A": (("symbol", "int32"), ("total", "float32"), ("avgPrice", "float32")),
    "G": (("k", "int32"), ("lv", "float32"), ("rv", "float32")),
    "N": (("symbol", "int32"), ("price", "float32")),
}


def _wire_batch(torch, rng, B: int, schema: str, case: str):
    """An output batch of B lanes: EXPIRED and RESET lanes among CURRENT
    ones; `case` none / all / half valid, or `span` (half valid, the last
    valid lane 2^32 ms after the first: the pack's `over`)."""
    dev = torch.device("cuda")
    ts = 1_700_000_000_000 + np.arange(B, dtype=np.int64)
    valid = {"none": np.zeros(B, bool), "all": np.ones(B, bool)}.get(
        case, rng.random(B) < 0.5)
    if case == "span":
        v = np.nonzero(valid)[0]
        ts[v[-1]] = ts[v[0]] + (1 << 32)
    types = rng.choice(np.array([0, 1, 3], np.int8), B)
    cols = {}
    for name, dt in WIRE_SCHEMAS[schema]:
        a = (rng.integers(0, 1_000_000, B).astype(np.int32) if dt == "int32"
             else rng.uniform(1, 1000, B).astype(np.float32))
        cols[name] = torch.from_numpy(a).to(dev)
    return (torch.from_numpy(ts).to(dev), torch.from_numpy(valid).to(dev),
            torch.from_numpy(types).to(dev), cols)


def k12a_edge_cases(torch, rng, dev, big: int = 1 << 20) -> dict:
    """K12a cases, name -> (ts, valid, types, columns) of app A's schema
    plus an int64, an int16 and a bool column: B = 0, 1, 256, 1,025,
    131,072 and `big` lanes half valid, every lane invalid, an `over`
    batch (the last valid lane 2^32 ms after the first), a span of 2^32 -
    1 (no `over`), and strided columns (views of a ring, ts and the valid
    flags every other lane)."""

    def batch(B, p_valid=0.5, span=None, strided=False):
        ts = 1_700_000_000_000 + np.cumsum(rng.integers(0, 3, B))
        valid = rng.random(B) < p_valid
        if span is not None and valid.any():
            v = np.nonzero(valid)[0]
            ts[v[-1]] = ts[v[0]] + span
        cols = {"symbol": rng.integers(0, 10**6, B).astype(np.int32),
                "total": rng.normal(size=B).astype(np.float32),
                "n": rng.integers(-2**40, 2**40, B),
                "q": rng.integers(-300, 300, B).astype(np.int16),
                "avgPrice": rng.normal(size=B).astype(np.float32),
                "f": rng.random(B) < 0.5}
        types = rng.choice(np.array([0, 1, 3], np.int8), B)
        if not strided:
            return (torch.from_numpy(ts).to(dev),
                    torch.from_numpy(valid).to(dev),
                    torch.from_numpy(types).to(dev),
                    {k: torch.from_numpy(v).to(dev)
                     for k, v in cols.items()})

        def every_other(a):
            two = np.repeat(a[:, None], 2, axis=1)
            return torch.from_numpy(two).to(dev)[:, 0]

        ring = {k: torch.from_numpy(np.stack([v, v, v], 1)).to(dev)[:, 1]
                for k, v in cols.items()}
        return (every_other(ts), every_other(valid),
                torch.from_numpy(types).to(dev), ring)

    return {"B = 0": batch(0), "B = 1": batch(1, 1.0),
            "B = 256": batch(256), "B = 1,025": batch(1025),
            "B = 131,072": batch(BATCH), f"B = {big}": batch(big),
            "every lane invalid": batch(4097, 0.0),
            "over": batch(70_001, 0.3, span=1 << 32),
            "span 2^32 - 1": batch(70_001, 0.3, span=(1 << 32) - 1),
            "strided columns": batch(50_000, strided=True)}


def check_k12a(wire, name, ts, valid, types, cols) -> None:
    """K12a against wire_pack_plain: the payload bit for bit; the
    unpacked count, over flag and timestamps exact."""
    layout = wire.layout_of(ts, cols)
    got = wire.wire_pack_cuda(ts, valid, types, cols, layout)
    want = wire.wire_pack_plain(ts, valid, types, cols, layout)
    check_equal(f"K12a {name}", wire.wire_payload(got, layout),
                wire.wire_payload(want, layout))
    host = wire.wire_unpack(got.cpu().numpy(), layout)
    idx = valid.nonzero().squeeze(1)
    span = (int(ts[idx].max() - ts[idx].min()) if idx.numel() else 0)
    if (host.count != idx.numel() or host.over != (span > 0xFFFFFFFF)
            or not np.array_equal(host.ts, ts[idx].cpu().numpy())):
        raise Failure(f"K12a {name}: the unpacked count, over flag or "
                      "timestamps are wrong")


def host_ms(torch, fn, iters: int = 20) -> float:
    """Mean host-clock ms of fn() from an idle card to an idle card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def wire_kernel_phase(torch, rng, B: int = BATCH, edge_rng=None) -> dict:
    """K12a against wire_pack_plain on the card, bit for bit, for three
    output schemas and four lane mixes; the unpacked timestamps exact
    (also past 32 bits); at k12a_edge_cases (from `edge_rng`), one launch
    a call, the sizes alternating on one stream; with its timings, and
    the copy of the packed buffer against the per-column readback it
    replaces."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import wire

    for schema in WIRE_SCHEMAS:
        for case in ("none", "all", "half", "span"):
            ts, valid, types, cols = _wire_batch(torch, rng, B, schema, case)
            layout = wire.layout_of(ts, cols)
            got = wire.wire_pack_cuda(ts, valid, types, cols, layout)
            want = wire.wire_pack_plain(ts, valid, types, cols, layout)
            check_equal(f"K12a {schema} {case}",
                        wire.wire_payload(got, layout),
                        wire.wire_payload(want, layout))
            host = wire.wire_unpack(got.cpu().numpy(), layout)
            idx = torch.nonzero(valid).squeeze(1)
            if (host.count != idx.numel() or host.over != (case == "span")
                    or not np.array_equal(host.ts, ts[idx].cpu().numpy())):
                raise Failure(f"K12a {schema} {case}: the unpacked count, "
                              "over flag or timestamps are wrong")
    print(f"K12a wire_pack B={B}: bit for bit against wire_pack_plain for "
          f"schemas {sorted(WIRE_SCHEMAS)} x none/all/half valid/2^32 span, "
          "EXPIRED and RESET lanes; timestamps exact")
    edge_rng = edge_rng if edge_rng is not None else \
        np.random.default_rng(14)
    cases = k12a_edge_cases(torch, edge_rng, torch.device("cuda"))
    big = max(cases, key=lambda n: cases[n][0].shape[0])
    order = list(cases) + [big, "B = 256", "over", big, "B = 0",
                           "strided columns"]
    for name in order:
        kernels.reset_launch_counts()
        check_k12a(wire, name, *cases[name])
        if kernels.LAUNCHES["K12a"] != 1:
            raise Failure(f"K12a edge {name}: {kernels.LAUNCHES['K12a']} "
                          "launches, one expected")
    print(f"K12a edges {list(cases)}: bit for bit, one launch a call, "
          "sizes alternating on one stream")
    del cases

    ts, valid, types, cols = _wire_batch(torch, rng, B, "A", "half")
    layout = wire.layout_of(ts, cols)

    n_valid = int(valid.sum())

    def library():  # nonzero_static at the known count (no host sync),
        # a gather per column and the minimum
        idx = torch.nonzero_static(valid, size=n_valid).squeeze(1)
        return ([t.index_select(0, idx) for t in (ts, types, *cols.values())],
                torch.min(ts.index_select(0, idx)))

    width = sum(c.element_size() for c in cols.values())
    buf = wire.wire_pack_cuda(ts, valid, types, cols, layout)
    host = wire.wire_unpack(buf.cpu().numpy(), layout)
    # what the function needs: ts, valid, types and the columns read once;
    # the header and each valid lane's dts, flags and columns written once,
    # its high words only on an `over` batch
    need = (B * (8 + 1 + 1 + width) + wire.HEADER_BYTES
            + host.count * (4 + 1 + width + (4 if host.over else 0)))
    res = {"K12a": dict(
        _timed(torch, lambda: wire.wire_pack_cuda(ts, valid, types, cols,
                                                  layout),
               lambda: wire.wire_pack_plain(ts, valid, types, cols, layout),
               library=library),
        bound_ms=bound_ms(need), max_abs_err=0, bound_by="bytes")}
    pinned = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
    copy_ms = time_ms(torch, lambda: pinned.copy_(buf, non_blocking=True))

    def per_column():  # the readback before this slice: 3 + n_cols copies
        v = valid.cpu().numpy()
        idx = torch.from_numpy(np.nonzero(v)[0]).to(ts.device)
        return [t[idx].cpu() for t in (ts, types, *cols.values())]

    percol_ms = host_ms(torch, per_column)
    packed_ms = host_ms(
        torch, lambda: wire.start_readback(ts, valid, types, cols).result())
    print(f"K12a B={B}, {host.count} valid lanes: {res['K12a']} (bound "
          f"from {need} bytes); device-to-host copy of the "
          f"{layout.nbytes}-byte packed buffer into pinned memory "
          f"{copy_ms:.4f} ms (CUDA events, {layout.nbytes / copy_ms / 1e6:.2f}"
          f" GB/s); whole packed readback (pack, copy, wait, unpack) "
          f"{packed_ms:.4f} ms against the per-column readback it replaces "
          f"({3 + len(cols)} blocking copies) {percol_ms:.4f} ms (host clock)")
    res["K12a"]["copy_ms"] = copy_ms
    return res


def make_runtime(text: str, batch: int, gcap: int = 0, config=None,
                 async_cb: bool = False):
    """A runtime on the card, with dtypes.config overrides in place while
    it is built."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core import dtypes

    config = config or {}
    prev = {k: getattr(dtypes.config, k) for k in config}
    for k, v in config.items():
        setattr(dtypes.config, k, v)
    try:
        return SiddhiManager().create_siddhi_app_runtime(
            text, batch_size=batch, group_capacity=gcap,
            async_callbacks=async_cb)
    finally:
        for k, v in prev.items():
            setattr(dtypes.config, k, v)


def watch_handoff(torch, found: dict):
    """Patch the hand-off of a step's output to the decoder (the pack and
    copy of EventBatch.readback, then AsyncDecoder.submit) so each call
    runs under torch.cuda.set_sync_debug_mode('warn'); a context manager
    that counts the calls and collects the syncs in `found`."""
    import contextlib

    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.stream import AsyncDecoder

    @contextlib.contextmanager
    def cm():
        saved = [(EventBatch, "readback", EventBatch.__dict__["readback"]),
                 (AsyncDecoder, "submit", AsyncDecoder.__dict__["submit"])]
        for cls, name, fn in saved:
            def watched(*a, _fn=fn, _name=name, **k):
                r, syncs = call_watching_syncs(torch, lambda: _fn(*a, **k))
                found["calls"] = found.get("calls", 0) + 1
                found.setdefault("syncs", []).extend(
                    f"{_name}: {x}" for x in syncs)
                return r
            setattr(cls, name, watched)
        try:
            yield
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)

    return cm()


def run_columnar(torch, text: str, sends: list, out_stream: str, batch: int,
                 gcap: int = 0, config=None):
    """The end-to-end path as bench.py drives it: async_callbacks=True, a
    ColumnarBlock callback, send_columns + flush per send, drain at the
    end. `sends`: [(stream, columns, timestamps)], advancing in event
    time. Returns (blocks, elapsed s, peak bytes, launches, send-to-callback
    ms per block, the hand-off watch of the second send)."""
    from siddhi_tpu_torch import kernels

    rt = make_runtime(text, batch, gcap, config, async_cb=True)
    blocks, arrivals = [], []

    def on_block(block):
        arrivals.append(time.perf_counter())
        blocks.append(block)

    rt.add_callback(out_stream, on_block, columnar=True)
    rt.start()
    hs = {s: rt.get_input_handler(s) for s, _, _ in sends}
    starts = np.array([int(t.min()) for _, _, t in sends])
    t_send, handoff = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i, (stream, cols, ts) in enumerate(sends):
        t_send.append(time.perf_counter())
        if i == 1:
            with watch_handoff(torch, handoff):
                hs[stream].send_columns(cols, timestamps=ts)
                rt.flush()
        else:
            hs[stream].send_columns(cols, timestamps=ts)
            rt.flush()
    rt.drain()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rt.shutdown()
    # a block belongs to the send holding its latest timestamp
    src = np.searchsorted(starts, [int(b.timestamps.max()) for b in blocks],
                          side="right") - 1
    lat = (np.array(arrivals) - np.array(t_send)[src]) * 1e3
    return blocks, elapsed, peak, launches, lat, handoff


STAGES = ("ingest", "step", "pack+copy", "unpack", "Event build",
          "block build")


def staged_run(torch, text: str, sends: list, out_stream: str, batch: int,
               rounds: int, gcap: int = 0, config=None) -> dict:
    """ms per round of each stage: a synchronous run with an Event and a
    columnar callback, the card synchronised at every stage boundary.
    ingest = StreamCodec.encode_columns + StreamJunction._batch (interning,
    padding, the copy to the card); pack+copy = EventBatch.readback
    (K12a, the copy, the wait); unpack = Readback.result; Event build /
    block build = the two callbacks' on_host; step = the rest (the query
    steps and the junctions around them)."""
    from siddhi_tpu_torch.core.event import EventBatch, StreamCodec
    from siddhi_tpu_torch.core.stream import (BatchStreamCallback,
                                              StreamCallback, StreamJunction)
    from siddhi_tpu_torch.ops.wire import Readback

    acc = dict.fromkeys(STAGES, 0.0)
    patches = [(StreamCodec, "encode_columns", "ingest"),
               (StreamJunction, "_batch", "ingest"),
               (EventBatch, "readback", "pack+copy"),
               (Readback, "result", "unpack"),
               (StreamCallback, "on_host", "Event build"),
               (BatchStreamCallback, "on_host", "block build")]

    def timed(fn, key):
        def w(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                acc[key] += time.perf_counter() - t0
        return w

    rt = make_runtime(text, batch, gcap, config)
    rt.add_callback(out_stream, lambda events: None)
    rt.add_callback(out_stream, lambda block: None, columnar=True)
    hs = {s: rt.get_input_handler(s) for s, _, _ in sends}
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in patches]
    try:
        for cls, name, key in patches:
            setattr(cls, name, timed(cls.__dict__[name], key))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for stream, cols, ts in sends:
            hs[stream].send_columns(cols, timestamps=ts)
            rt.flush()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    rt.shutdown()
    acc["step"] = total - sum(v for k, v in acc.items() if k != "step")
    return {k: v * 1e3 / rounds for k, v in acc.items()}


def columnar_pair(torch, name: str, text: str, sends: list, out_stream: str,
                  batch: int, rounds: int, check, ev_elapsed: float,
                  card: str, summary: dict, gcap: int = 0,
                  config=None) -> dict:
    """App `name` through the columnar async path on the same input as its
    Event run: every block's rows against the same oracle (`check` of the
    blocks' events), K12a launched, no host sync at the decoder hand-off;
    then the stage split. Fills summary[name]; returns the launches."""
    blocks, elapsed, peak, launches, lat, handoff = run_columnar(
        torch, text, sends, out_stream, batch, gcap, config)
    n_in = sum(len(t) for _, _, t in sends)
    n_out = check([e for b in blocks for e in b.to_events()])
    if sum(b.count for b in blocks) != n_out:
        raise Failure(f"app {name} columnar: block counts do not add up")
    del blocks
    if not len(lat):
        raise Failure(f"app {name} columnar: no block delivered")
    if launches["K12a"] == 0:
        raise Failure(f"app {name} columnar: kernel K12a never launched")
    if not handoff.get("calls"):
        raise Failure(f"app {name} columnar: no decoder hand-off watched")
    if handoff.get("syncs"):
        raise Failure(f"app {name} columnar: the decoder hand-off syncs "
                      f"with the host: {handoff['syncs']}")
    stages = staged_run(torch, text, sends, out_stream, batch, rounds, gcap,
                        config)
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    summary[name] = {
        "events_per_s_event": n_in / ev_elapsed,
        "events_per_s_columnar": n_in / elapsed,
        "stages_ms_per_round": stages, "latency_ms_p50": p50,
        "latency_ms_p99": p99, "blocks": len(lat),
        "peak_mib": peak / 2**20, "handoff_syncs": 0}
    print(f"app {name} columnar: {n_in} events in, {n_out} out in "
          f"ColumnarBlocks, matches the oracle; {n_in / elapsed:.1f} "
          f"events/s end to end (async_callbacks=True, columnar) against "
          f"{n_in / ev_elapsed:.1f} (Event callback, synchronous); "
          f"{elapsed * 1e3 / rounds:.3f} against "
          f"{ev_elapsed * 1e3 / rounds:.3f} ms per round; split ms per "
          "round (synchronous run, card synchronised at each stage): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; send-to-callback latency p50 {p50:.3f} ms p99 {p99:.3f} ms "
          f"over {len(lat)} blocks; peak device memory "
          f"{peak / 2**20:.1f} MiB; host syncs at the decoder hand-off: 0 "
          f"in {handoff['calls']} calls [{card}]")
    return launches


def python_encoder_run(torch, name: str, text: str, columns: dict, ts,
                       out_stream: str, check, ev_elapsed: float, card: str,
                       summary: dict) -> None:
    """App `name`'s Event run again in the same call, with the Python host
    encoder in place of the native one (interning, string decode and Event
    building in Python; the pack and copy unchanged): every event against
    the oracle, and the rate beside the native run's."""
    from siddhi_tpu_torch import native

    saved = native.load
    native.load = lambda: None
    try:
        rt, got, _, elapsed, _ = run_app(torch, text, columns, ts,
                                         out_stream=out_stream)
        check(got)
    finally:
        native.load = saved
    del rt, got
    n_in = len(ts)
    summary[name]["events_per_s_event_python_encoder"] = n_in / elapsed
    print(f"app {name} Event path with the Python host encoder: "
          f"{n_in / elapsed:.1f} events/s against {n_in / ev_elapsed:.1f} "
          f"with the native one ({elapsed * 1e3 / ROUNDS:.3f} against "
          f"{ev_elapsed * 1e3 / ROUNDS:.3f} ms per round), matches the "
          f"oracle [{card}]")


def round_sends(stream: str, columns: dict, ts, rounds: int = ROUNDS,
                batch: int = BATCH) -> list:
    return [(stream, {k: v[r * batch:(r + 1) * batch]
                      for k, v in columns.items()},
             ts[r * batch:(r + 1) * batch]) for r in range(rounds)]


def check_n(got, sym, price32, ts, pool) -> int:
    """App N: every passing event (700.0 > price in float32), in order,
    with its symbol and stored price."""
    keep = np.float32(700.0) > price32
    n = int(keep.sum())
    if len(got) != n:
        raise Failure(f"app N: {len(got)} events out, the oracle expects "
                      f"{n}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, n)
    g_p = np.fromiter((e.data[1] for e in got), np.float64, n)
    if not np.array_equal(g_ts, ts[keep]):
        raise Failure("app N: timestamps differ from the oracle")
    if [e.data[0] for e in got] != pool[sym[keep]].tolist():
        raise Failure("app N: symbols differ from the oracle")
    if not np.array_equal(g_p, price32[keep].astype(np.float64)):
        raise Failure("app N: prices differ from the oracle")
    return n


def config1_app(torch, rng, card: str, summary: dict) -> dict:
    """App N, BASELINE config 1 (filter + project): its Event run and its
    columnar async run against the numpy oracle; returns the launches."""
    n = ROUNDS * BATCH
    sym = rng.integers(0, N_SYMBOLS, n)
    price = rng.uniform(0.0, N_PRICE_HI, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    pool = symbols(N_SYMBOLS)
    columns = {"symbol": pool[sym], "price": price, "volume": volume}
    price32 = price.astype(np.float32)
    rt, got, launches, elapsed, peak = run_app(
        torch, APP_N, columns, ts, out_stream="OutStream", rounds=ROUNDS,
        batch=BATCH)
    n_out = check_n(got, sym, price32, ts, pool)
    del got
    if launches["K12a"] == 0:
        raise Failure("app N: kernel K12a never launched")
    syncs, step_ms = measure_steps(torch, rt, columns, ts, rounds=ROUNDS,
                                   batch=BATCH)
    report_app("N", n, n_out, elapsed, step_ms, peak, launches, syncs, card,
               rounds=ROUNDS, batch=BATCH)
    del rt
    col = columnar_pair(torch, "N", APP_N, round_sends(
        "TradeStream", columns, ts, ROUNDS, BATCH), "OutStream", BATCH, ROUNDS,
        lambda g: check_n(g, sym, price32, ts, pool), elapsed, card,
        summary, gcap=GROUP_CAP)
    python_encoder_run(torch, "N", APP_N, columns, ts, "OutStream",
                       lambda g: check_n(g, sym, price32, ts, pool), elapsed,
                       card, summary)
    return {k: launches[k] + col[k] for k in launches}


# --------------------------------------------------------------------------- #
# phases 18-19: K7 and the session, keyed-session, named and sort windows
# --------------------------------------------------------------------------- #

GAP_S = 5000  # session gap of apps S and T, ms
N_V = 10_000  # app V's leaderboard
T_SYMBOLS = 1_000
T_GROUPS = 4  # app T's symbols take turns in groups of 250
T_PHASE = 20_000  # events a phase, 1 ms apart: a group is quiet 60 s
S_BURST = (1_000, 50_001)  # app S's burst lengths, events 1 ms apart
S_JUMP = (GAP_S + 1_000, 20_001)  # and the idle jumps between them, ms

APP_S = f"""
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.session({GAP_S // 1000} sec)
select symbol, price, volume
insert all events into OutStream;
"""

APP_T = f"""
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.session({GAP_S // 1000} sec, symbol)
select symbol, price, volume
insert all events into OutStream;
"""

# app D's query through a named window
APP_U = """
@app:playback
define stream TradeStream (symbol string, price double, volume long);
define window TradeWindow (symbol string, price double, volume long)
  length(100000) output all events;
from TradeStream insert into TradeWindow;
@info(name = 'bench')
from TradeWindow
select symbol, sum(price) as total, count() as n
group by symbol
insert into OutStream;
"""

APP_V = f"""
@app:playback
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream#window.sort({N_V}, price, 'desc', volume)
select symbol, price, volume
insert all events into OutStream;
"""


def sort_kernel_phase(torch, rng) -> dict:
    """K7 against its plain version at each on-path site's shape, bit for
    bit, with its timings: (a) app S's chunk, (b) app V's chunk, (c) app
    V's rank passes (float64 keys with ties, -0.0, NaN and ±inf, asc and
    desc; and the whole two-key _rank_key on the card against the CPU),
    (d) app T's key grouping, (e) app T's top-E."""
    from siddhi_tpu_torch.ops import search
    from siddhi_tpu_torch.ops.windows import SortWindow, _chunk_key_bound

    dev = torch.device("cuda")
    B, N = BATCH, N_V
    res = {}

    def site(counter, keys, bound, width, what, library_keys=None):
        keys = keys.to(dev)
        width = keys.numel() if width is None else width
        got = search.stable_radix_argsort(keys, bound, width,
                                          counter=counter)
        want = search.stable_radix_argsort_plain(keys, bound, width)
        check_equal(f"{counter} ({what})", got, want)
        lib = keys if library_keys is None else library_keys.to(dev)
        res[counter] = dict(
            _timed(torch,
                   lambda: search.stable_radix_argsort(keys, bound, width,
                                                       counter=counter),
                   lambda: search.stable_radix_argsort_plain(keys, bound,
                                                             width),
                   library=lambda: torch.sort(lib, stable=True)),
            # the keys read once, the order written once
            bound_ms=bound_ms(keys.numel() * keys.element_size()
                              + width * 4),
            max_abs_err=0, bound_by="bytes")
        print(f"{counter} {what} L={keys.numel()} width={width}: "
              f"{res[counter]}")

    bound = _chunk_key_bound(B)

    def chunk_keys(L, p_valid):
        k = rng.integers(0, B + 1, L) * 4 + rng.choice([0, 2], L)
        return torch.from_numpy(np.where(rng.random(L) < p_valid, k, bound)
                                .astype(np.int32))

    # (a) E ring lanes, B arrival-expired and B currents, ~40% invalid;
    # all of them kept (the JAX window keeps 2B, ROADMAP.md Queue 3)
    site("K7 session chunk", chunk_keys(3 * B, 0.6), bound, None,
         "app S's chunk")
    # (b) B currents (all valid) then N + B merge lanes at 4B, ~B evicted
    ev = np.where(rng.random(N + B) < B / (N + B), 4 * B, bound)
    keys_v = np.concatenate([np.arange(B) * 4 + 2, ev]).astype(np.int32)
    site("K7 sort chunk", torch.from_numpy(keys_v), bound, None,
         "app V's chunk")
    # (c) M = N + B float keys, many ties, specials planted
    x = rng.integers(0, 2000, N + B).astype(np.float64) * 0.05
    for v in (0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf):
        x[rng.integers(0, x.size, 50)] = v
    xt = torch.from_numpy(x)
    asc = search.float64_sort_key(xt.to(dev), False)
    got = search.stable_radix_argsort(asc, counter="K7 rank")
    check_equal("K7 rank (asc)", got,
                search.stable_radix_argsort_plain(asc))
    site("K7 rank", search.float64_sort_key(xt, True), None, None,
         "app V's rank pass, desc", library_keys=-xt)
    win = SortWindow({"price": torch.float32, "volume": torch.int64}, B, N,
                     [("price", -1), ("volume", 1)])
    cols = {"price": torch.from_numpy(x.astype(np.float32)),
            "volume": torch.from_numpy(rng.integers(1, 20, N + B))}
    valid = torch.from_numpy(rng.random(N + B) < 0.95)
    check_equal("K7 _rank_key (two keys, card vs CPU)",
                win._rank_key({k: v.to(dev) for k, v in cols.items()},
                              valid.to(dev)).cpu(),
                win._rank_key(cols, valid))
    # (d) B symbol codes < 1000 of K = 4096 slots, 3% invalid (K)
    K = 4096
    kg = np.where(rng.random(B) < 0.97, rng.integers(1, T_SYMBOLS + 1, B), K)
    site("K7 keyed group", torch.from_numpy(kg.astype(np.int32)), K, None,
         "app T's key grouping")
    # (e) ages of C = 2B ring rows, half closed, the oldest E = B
    C = 2 * B
    ages = np.where(rng.random(C) < 0.5, rng.permutation(C), C)
    site("K7 keyed top-E", torch.from_numpy(ages.astype(np.int32)), C, B,
         "app T's top-E")
    torch.cuda.synchronize()
    return res


def session_events(rng, rounds: int = ROUNDS, batch: int = BATCH):
    """App S's traffic: bursts of 1,000-50,000 events 1 ms apart, idle
    jumps of 6-20 s between them."""
    n = rounds * batch
    steps = np.ones(n, dtype=np.int64)
    i = int(rng.integers(*S_BURST))
    while i < n:
        steps[i] = rng.integers(*S_JUMP)
        i += int(rng.integers(*S_BURST))
    ts = 1_700_000_000_000 + np.cumsum(steps)
    sym = rng.integers(0, T_SYMBOLS, n)
    return (sym, rng.uniform(1.0, 100.0, n),
            rng.integers(1, 1000, n).astype(np.int64), ts)


def oracle_s(ts: np.ndarray, batch: int = BATCH) -> np.ndarray:
    """Output row indices of app S: each session's currents, then the same
    rows expired, which come out before the next session's first current
    (or at the heartbeat whose clock closes the session; the last one at
    the closing heartbeat). As in the JAX package, no gap breaks a
    session inside the very first batch (its break needs
    `state.has_events`, siddhi_tpu/ops/windows.py:1106; ROADMAP.md,
    Queue 3). Every row comes out: the JAX window keeps only the first
    B + E lanes of a step's chunk and the port all of them (Queue 3)."""
    n = ts.shape[0]
    idx = np.arange(n)
    start = np.r_[True, np.diff(ts) > GAP_S]
    start[1:batch] = False
    first = np.maximum.accumulate(np.where(start, idx, 0))
    end = np.r_[np.nonzero(start)[0][1:], n]  # one past each session
    last = end[np.cumsum(start) - 1]
    # before session s: 2 * first(s) rows; then its currents, its expired
    out = np.empty(2 * n, dtype=np.int64)
    out[first + idx] = idx
    out[idx + last] = idx
    return out


def keyed_events(rng, rounds: int = ROUNDS, batch: int = BATCH):
    """App T's traffic: 1 ms apart; 1,000 symbols in 4 groups of 250 take
    turns in phases of T_PHASE events, so a symbol goes quiet for 60 s
    between its phases."""
    n = rounds * batch
    group = (np.arange(n) // T_PHASE) % T_GROUPS
    per = T_SYMBOLS // T_GROUPS
    sym = group * per + rng.integers(0, per, n)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return (sym, rng.uniform(1.0, 100.0, n),
            rng.integers(1, 1000, n).astype(np.int64), ts)


def oracle_t(sym, ts, nows, rounds: int = ROUNDS, batch: int = BATCH):
    """Output (row index, expired) of app T, step by step: a key's session
    closes at the step where its next event arrives (after a gap over
    GAP_S) or where the step's clock passes its last event by GAP_S,
    whichever comes first; a step emits the oldest E = B closed rows not
    yet emitted, then its batch's currents. `nows` are the steps' clocks
    (rounds, then the closing heartbeats). Fails if the traffic would
    overwrite a row of the C = 2B ring before it is emitted."""
    n = sym.shape[0]
    E, C = batch, 2 * batch
    idx = np.arange(n)
    nxt = next_same(sym)
    is_last = (nxt == n) | (ts[np.minimum(nxt, n - 1)] - ts > GAP_S)
    order = np.lexsort((idx, sym))
    pos = np.where(is_last[order], np.arange(n), n)
    last_sorted = np.minimum.accumulate(pos[::-1])[::-1]
    last = np.empty(n, dtype=np.int64)
    last[order] = order[last_sorted]
    by_next = np.where(nxt[last] < n, nxt[last] // batch, 1 << 30)
    by_clock = np.searchsorted(np.asarray(nows), ts[last] + GAP_S,
                               side="right")
    close = np.minimum(by_next, by_clock)
    out_i, out_e = [], []
    pending = np.empty(0, dtype=np.int64)
    for r in range(len(nows)):
        pending = np.sort(np.concatenate([pending, idx[close == r]]))
        emit, pending = pending[:E], pending[E:]
        appended = min((r + 1) * batch, n)
        if emit.size and emit[0] < appended - C:
            raise Failure("app T traffic: a row leaves the ring before its "
                          "session's expiry is emitted")
        out_i.append(emit)
        out_e.append(np.ones(emit.size, dtype=bool))
        if r < rounds:
            cur = idx[r * batch:(r + 1) * batch]
            out_i.append(cur)
            out_e.append(np.zeros(cur.size, dtype=bool))
    if pending.size:
        raise Failure(f"app T oracle: {pending.size} rows still pending "
                      "after the closing heartbeats")
    return np.concatenate(out_i), np.concatenate(out_e)


def oracle_v(price32, volume, ts, rounds: int = ROUNDS, batch: int = BATCH):
    """Output (row index, timestamp) of app V: each round its arrivals,
    then the rows the top-N_V leaderboard (price desc, volume asc, merge
    position) evicts, in merge order (the kept rows in rank order, then
    the arrivals), stamped with the round's clock."""
    kept = np.empty(0, dtype=np.int64)
    out_i, out_t = [], []
    for r in range(rounds):
        arr = np.arange(r * batch, (r + 1) * batch)
        merged = np.concatenate([kept, arr])
        rank = np.lexsort((np.arange(merged.size), volume[merged],
                           -price32[merged].astype(np.float64)))
        keep = np.zeros(merged.size, dtype=bool)
        keep[rank[:N_V]] = True
        ev = merged[~keep]
        out_i += [arr, ev]
        out_t += [ts[arr], np.full(ev.size, ts[arr[-1]])]
        kept = merged[rank[:N_V]]
    return np.concatenate(out_i), np.concatenate(out_t)


def session_sort_apps(torch, rng, card: str, rounds: int = ROUNDS,
                      batch: int = BATCH) -> dict:
    """Apps S, T, U and V against their oracles; each reads its own launch
    counts; 0 host syncs a step; returns their launches."""
    total = {}
    pool = symbols(T_SYMBOLS)
    for name in ("S", "T", "U", "V"):
        after, nows_t = None, None
        if name == "S":
            text, on_path = APP_S, ("K1", "K7 session chunk")
            sym, price, volume, ts = session_events(rng, rounds, batch)

            def after(rt, r, ts=ts):
                # mid-jump heartbeats close a session by the watermark;
                # the last one reaches past the final gap
                nxt = ((r + 1) * batch if r + 1 < rounds else None)
                rt.heartbeat(int(ts[nxt]) - 1 if nxt is not None
                             else int(ts[-1]) + GAP_S + 1)
        elif name == "T":
            text, on_path = APP_T, ("K1", "K7 keyed group", "K7 keyed top-E")
            sym, price, volume, ts = keyed_events(rng, rounds, batch)
            end = int(ts[-1]) + GAP_S + 1
            nows_t = [int(ts[(r + 1) * batch - 1]) for r in range(rounds)]
            nows_t += [end, end, end]

            def after(rt, r, end=end):
                if r == rounds - 1:
                    for _ in range(3):  # drain E closed rows a step
                        rt.heartbeat(end)
        elif name == "U":
            text, on_path = APP_U, ("K1", "K2b append", "K5")
            sym, price, volume, ts = sliding_events(rng, N_KEYS)
            sym = sym[:rounds * batch]
            price, volume, ts = (a[:rounds * batch]
                                 for a in (price, volume, ts))
        else:
            text, on_path = APP_V, ("K1", "K7 sort chunk", "K7 rank")
            sym, price, volume, ts = sliding_events(rng, T_SYMBOLS)
            sym = sym[:rounds * batch]
            price, volume, ts = (a[:rounds * batch]
                                 for a in (price, volume, ts))
        names = pool if name != "U" else symbols(N_KEYS)
        columns = {"symbol": names[sym], "price": price, "volume": volume}
        rt, got, launches, elapsed, peak = run_app(
            torch, text, columns, ts, out_stream="OutStream", rounds=rounds,
            batch=batch, after_round=after)
        price32 = price.astype(np.float32)
        if name == "U":
            total_d, count_d = oracle_d(sym, price32)
            expect = [("symbol", columns["symbol"].tolist(), False),
                      ("total", total_d, True), ("n", count_d, False)]
            n_out = check_sliding(name, got, ts, expect)
        else:
            if name == "S":
                oi = oracle_s(ts, batch)
                ots = ts[oi]
            elif name == "T":
                oi, _ = oracle_t(sym, ts, nows_t, rounds, batch)
                ots = ts[oi]
            else:
                oi, ots = oracle_v(price32, volume, ts, rounds, batch)
            expect = [("symbol", columns["symbol"][oi].tolist(), False),
                      ("price", price32[oi].astype(np.float64), "exact"),
                      ("volume", volume[oi], False)]
            n_out = check_sliding(name, got, ots, expect)
        del got
        if name == "T":
            rt.collect_overflow()
            dropped = rt.ctx.statistics.overflow.get(
                "query:bench.session_key_dropped", 0)
            if dropped or int(rt.query_runtimes["bench"].state[0].dropped):
                raise Failure(f"app T: {dropped} events dropped past the "
                              "key capacity")
        for k in on_path + ("K12a",):
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        syncs, step_ms = measure_steps(
            torch, rt, columns, ts, fresh=True, rounds=rounds, batch=batch,
            window="TradeWindow" if name == "U" else None)
        report_app(name, ts.shape[0], n_out, elapsed, step_ms, peak,
                   launches, syncs, card, rounds=rounds, batch=batch)
        if syncs:
            raise Failure(f"app {name}: the step syncs with the host: "
                          f"{syncs}")
        del rt
    return total


# --------------------------------------------------------------------------- #
# phases 20-21: K7's packed chunk sort, K13a, K13b; apps W, X, Y and Z
# --------------------------------------------------------------------------- #

W_LENGTH = 100_000  # app W's count bound
X_VOLUME = 5_000_000  # app X's volume budget
X_PRICE = 10_000.0  # app X's batch price budget
Y_SYMBOLS = 10_000
Y_ZIPF = 1.2
Y_SLOTS = 64
Y_WIDE = 9_600  # above the ~9,400 distinct symbols of a batch
Y_SUPPORT, Y_ERROR = 0.001, 0.0001
Z_RATE = 20_000  # app Z's events a second: a round spans ~6.5 s
Z_WINDOW_MS, Z_HOP_MS = 10_000, 1_000
STOCK = """@app:playback
define stream TradeStream (symbol string, price double, volume long);
"""


def expr_app_plan(w_length: int = W_LENGTH, x_volume: int = X_VOLUME,
                  x_price: float = X_PRICE, y_slots: int = Y_SLOTS,
                  y_wide: int = Y_WIDE) -> dict:
    """name -> (app text, {query: output stream}) of apps W, X, Y and Z."""
    def q(name, window, select, out, kind="all events "):
        return (f"@info(name = '{name}')\nfrom TradeStream{window}\n"
                f"select {select}\ninsert {kind}into {out};\n")

    rows = "symbol, price, volume"
    return {
        "W": (STOCK + q("bench", f"#window.expression('count() <= "
                        f"{w_length}')", rows, "OutStream"),
              {"bench": "OutStream"}),
        "X": (STOCK + q("bench", f"#window.expression('sum(volume) <= "
                        f"{x_volume}')", rows, "OutStream")
              + q("batch", f"#window.expressionBatch('sum(price) < "
                  f"{x_price}', true)", rows, "BatchOut"),
              {"bench": "OutStream", "batch": "BatchOut"}),
        "Y": (STOCK + q("bench", f"#window.frequent({y_slots}, symbol)",
                        rows, "OutStream")
              + q("wide", f"#window.frequent({y_wide}, symbol)", rows,
                  "WideOut")
              + q("lossy", f"#window.lossyFrequent({Y_SUPPORT}, "
                  f"{Y_ERROR}, symbol)", rows, "LossyOut"),
              {"bench": "OutStream", "wide": "WideOut",
               "lossy": "LossyOut"}),
        "Z": (STOCK + q("bench", "#pol2Cart(price, volume)#window.hopping("
                        f"{Z_WINDOW_MS // 1000} sec, {Z_HOP_MS // 1000} "
                        "sec)[x > 0.0]", "symbol, sum(x) as sx, count() as "
                        "n\ngroup by symbol", "OutStream", kind="")
              + q("cron", "#window.cron('*/1 * * * * ?')", rows, "CronOut"),
              {"bench": "OutStream", "cron": "CronOut"}),
    }


def _env_of(torch, cond, data: dict, C: int, B: int, w0: int, nv: int):
    """Metric arrays for a condition: value sequences of length C + B (rows
    past w0 + nv zero) and their prefix sums, float64, on the device."""
    env = {}
    for kind, attr in cond.program.arrays:
        seq = np.zeros(C + B)
        seq[:w0 + nv] = data[attr][:w0 + nv]
        if kind == "prefix":
            seq = np.r_[0.0, np.cumsum(seq)]
        elif kind == "prefix_sq":
            seq = np.r_[0.0, np.cumsum(seq * seq)]
        env[(kind, attr)] = torch.from_numpy(seq).to(torch.device("cuda"))
    return env


def _walk_bytes(cond, positions: int, out_bytes: int) -> float:
    """Bytes K13a must move: each float64 array that the condition's program
    indexes, read at the `positions` distinct positions this walk visits,
    and the outputs written once."""
    return len(cond.program.arrays) * positions * 8 + out_bytes


def expression_kernel_phase(torch, rng, B: int = BATCH) -> dict:
    """K7's packed chunk sort, K13a (both modes), K13b and the frequent
    windows' K7 int64 sorts against their plain versions on the card at
    the apps' shapes, bit for bit, with their timings: (a) app W's chunk
    (L = E + B) and app X's batch chunk (L = 2P + B), also through the
    whole `_sort_chunk_packed` against the CPU; (b) K13a's sliding walk
    on app X's condition at its steady state, and its batch scan; (c)
    K13a on seven conditions over first/last/current attributes, avg,
    stdDev, eventTimestamp, `%` with negative operands and windows that
    empty (NaN means) at B = 2048, both modes; (d) K13b at app Y's N = 64
    and N = 10,000; (e) app Y's key sort (B int64 keys) and slot-key sort
    (N = 10,000)."""
    from siddhi_tpu_torch.ops import expression_general as eg
    from siddhi_tpu_torch.ops import search, windows, windows_extra as wx

    dev = torch.device("cuda")
    res = {}
    layout = {"symbol": torch.int32, "price": torch.float64,
              "volume": torch.int64}
    bound = 4 * B + 4

    # (a) hi keys of both callers' form, ~half the expiry lanes valid
    def packed_keys(n_exp, n_cur, exp_kind):
        hi = np.r_[np.sort(rng.integers(0, B + 1, n_exp)) * 4 + exp_kind,
                   np.arange(n_cur) * 4 + 2]
        valid = np.r_[rng.random(n_exp) < 0.5, rng.random(n_cur) < 0.97]
        return hi.astype(np.int32), valid

    for what, (hi, valid) in (("app W's chunk", packed_keys(B, B, 3)),
                              ("app X's batch chunk",
                               packed_keys(4 * B, B, 0))):
        k = torch.from_numpy(np.where(valid, hi, bound).astype(np.int32))
        kd = k.to(dev)
        got = search.stable_radix_argsort(kd, bound,
                                          counter="K7 packed chunk")
        check_equal(f"K7 packed chunk ({what})", got,
                    search.stable_radix_argsort_plain(kd, bound))
        L = hi.shape[0]
        mat = torch.from_numpy(rng.integers(
            -2**31, 2**31, (windows._layout_words(layout), L))
            .astype(np.int32))
        emit = torch.from_numpy(rng.integers(0, 2**40, L))
        types = torch.from_numpy(rng.integers(0, 3, L).astype(np.int8))
        args = (torch.from_numpy(hi), mat, emit, torch.from_numpy(valid),
                types, layout, L, bound)
        want = windows._sort_chunk_packed(*args)
        chunk = windows._sort_chunk_packed(
            *[a.to(dev) if isinstance(a, torch.Tensor) else a
              for a in args])
        for f in ("ts", "valid", "types"):
            check_equal(f"_sort_chunk_packed {f} ({what})",
                        getattr(chunk, f).cpu(), getattr(want, f))
        for c in layout:
            check_equal(f"_sort_chunk_packed {c} ({what})",
                        chunk.cols[c].cpu(), want.cols[c])
        if what == "app W's chunk":
            res["K7 packed chunk"] = dict(
                _timed(torch,
                       lambda: search.stable_radix_argsort(
                           kd, bound, counter="K7 packed chunk"),
                       lambda: search.stable_radix_argsort_plain(kd, bound),
                       library=lambda: torch.sort(kd, stable=True)),
                bound_ms=bound_ms(2 * L * 4), max_abs_err=0,
                bound_by="bytes")
            print(f"K7 packed chunk {what} L={L}: {res['K7 packed chunk']}")

    # (b) K13a at app X's shapes
    win = eg.GeneralExpressionWindow(layout, B, f"sum(volume) <= {X_VOLUME}")
    vol = rng.integers(1, 101, win.C + B).astype(np.float64)
    w0 = int(np.searchsorted(np.cumsum(vol), X_VOLUME))
    env = _env_of(torch, win.cond, {"volume": vol}, win.C, B, w0, B)
    w0_d = torch.tensor(w0, dtype=torch.int32, device=dev)
    nv_d = torch.tensor(B, dtype=torch.int32, device=dev)
    got = eg.sliding_walk(win.cond, env, w0_d, nv_d, B, win.E)
    want = eg.sliding_walk_plain(win.cond, env, w0_d, nv_d, B, win.E)
    for g, w, f in zip(got, want, ("s_vec", "s")):
        check_equal(f"K13a sliding ({f}, app X)", g, w)
    pops = int(want[1])
    # the walk reads positions [0, final s] (pops) and [w0, w0 + B]
    visited = (w0 + B + 1 if pops >= w0 else pops + 1 + B + 1)
    res["K13a sliding"] = dict(
        ms=device_ms(torch, lambda: eg.sliding_walk(win.cond, env, w0_d,
                                                    nv_d, B, win.E),
                     iters=5, warmup=1),
        call_ms=time_ms(torch, lambda: eg.sliding_walk(win.cond, env, w0_d,
                                                       nv_d, B, win.E),
                        iters=2, warmup=0),
        plain_ms=time_ms(torch, lambda: eg.sliding_walk_plain(
            win.cond, env, w0_d, nv_d, B, win.E), iters=1, warmup=0),
        library_ms=None, bound_ms=bound_ms(_walk_bytes(win.cond, visited,
                                                   4 * B + 4)),
        max_abs_err=0, bound_by="bytes", checks=B + pops)
    print(f"K13a sliding walk, app X's condition, B={B}, window {w0} rows, "
          f"{B + pops} checks: {res['K13a sliding']}")

    bwin = eg.GeneralExpressionBatchWindow(
        layout, B, f"sum(price) < {X_PRICE}", include_trigger=True)
    price = rng.integers(32, 6400, bwin.C + B) / 64.0
    w0b = 150
    benv = _env_of(torch, bwin.cond, {"price": price}, bwin.C, B, w0b, B)
    w0b_d = torch.tensor(w0b, dtype=torch.int32, device=dev)
    got = eg.batch_walk(bwin.cond, benv, w0b_d, nv_d, B, True)
    want = eg.batch_walk_plain(bwin.cond, benv, w0b_d, nv_d, B, True)
    for g, w, f in zip(got, want, ("flush", "end_j", "empty", "s")):
        check_equal(f"K13a batch ({f}, app X)", g, w)
    # the scan reads each segment start and [w0, w0 + B]
    starts = want[1].cpu().numpy()[want[0].cpu().numpy().astype(bool)]
    bvisited = np.union1d(np.r_[0, starts],
                          np.arange(w0b, w0b + B + 1)).size
    res["K13a batch"] = dict(
        ms=device_ms(torch, lambda: eg.batch_walk(bwin.cond, benv, w0b_d,
                                                  nv_d, B, True),
                     iters=5, warmup=1),
        call_ms=time_ms(torch, lambda: eg.batch_walk(bwin.cond, benv, w0b_d,
                                                     nv_d, B, True),
                        iters=2, warmup=0),
        plain_ms=time_ms(torch, lambda: eg.batch_walk_plain(
            bwin.cond, benv, w0b_d, nv_d, B, True), iters=1, warmup=0),
        library_ms=None, bound_ms=bound_ms(_walk_bytes(bwin.cond, bvisited,
                                                   6 * B + 4)),
        max_abs_err=0, bound_by="bytes", checks=B)
    print(f"K13a batch scan, app X's condition, B={B}, "
          f"{int(want[0].sum())} flushes: {res['K13a batch']}")

    # (c) the walk's semantics, both modes
    Bs, Cs = 2048, 4096
    data = {"price": rng.integers(-4000, 6400, Cs + Bs) / 64.0,
            "volume": rng.integers(-50, 50, Cs + Bs).astype(np.float64),
            eg.TS_ATTR: (1_000 + np.cumsum(rng.integers(0, 9, Cs + Bs)))
            .astype(np.float64)}
    layout_s = {"price": torch.float64, "volume": torch.int64}
    for text in ("stdDev(price) < 30.0 and count() < 300",
                 "avg(price) >= 10.0 or last.volume % 7 != 3",
                 "(last.price - first.price) % -7.5 < 3.0",
                 "eventTimestamp(last) - eventTimestamp(first) <= 500 "
                 "and not (price > 90.0)",
                 "sum(volume) / count() > -1.5",
                 "avg(price) > 1000.0",
                 "volume % 4 == -1 or first.volume * 2 < price"):
        for w0s in (0, 700):
            sw = eg.GeneralExpressionWindow(layout_s, Bs, text)
            senv = _env_of(torch, sw.cond, data, Cs, Bs, w0s, Bs - 5)
            a = (torch.tensor(w0s, dtype=torch.int32, device=dev),
                 torch.tensor(Bs - 5, dtype=torch.int32, device=dev))
            for g, w in zip(eg.sliding_walk(sw.cond, senv, *a, Bs, sw.E),
                            eg.sliding_walk_plain(sw.cond, senv, *a, Bs,
                                                  sw.E)):
                check_equal(f"K13a sliding ({text!r}, w0={w0s})", g, w)
            for inc in (False, True):
                for g, w in zip(eg.batch_walk(sw.cond, senv, *a, Bs, inc),
                                eg.batch_walk_plain(sw.cond, senv, *a, Bs,
                                                    inc)):
                    check_equal(f"K13a batch ({text!r}, w0={w0s}, "
                                f"include={inc})", g, w)
    print("K13a: 7 conditions x 2 windows, both modes, match the plain walk")

    # (d) K13b at app Y's shapes
    sym = np.minimum(rng.zipf(Y_ZIPF, B), Y_SYMBOLS) - 1
    comp = {"symbol": torch.from_numpy(sym.astype(np.int32)),
            "price": torch.from_numpy(rng.uniform(1, 100, B)),
            "volume": torch.from_numpy(rng.integers(1, 1000, B))}
    comp_ts = torch.from_numpy(1_700_000_000_000 + np.arange(B))
    for N in (Y_SLOTS, Y_SYMBOLS):
        slot = torch.from_numpy(np.where(sym < N, sym, N).astype(np.int32))
        old = {"symbol": torch.from_numpy(rng.integers(0, 9, N)
                                          .astype(np.int32)),
               "price": torch.from_numpy(rng.uniform(1, 100, N)),
               "volume": torch.from_numpy(rng.integers(1, 1000, N))}
        old_ts = torch.from_numpy(rng.integers(0, 2**40, N))
        a = [slot.to(dev), {k: v.to(dev) for k, v in comp.items()},
             comp_ts.to(dev), {k: v.to(dev) for k, v in old.items()},
             old_ts.to(dev), N]
        gc, gt = wx.frequent_last_lane(*a)
        wc, wt = wx.frequent_last_lane_plain(*a)
        check_equal(f"K13b ts (N={N})", gt, wt)
        for k in comp:
            check_equal(f"K13b {k} (N={N})", gc[k], wc[k])

        def library(a=a):
            last = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
            last.scatter_reduce_(0, a[0].long(), torch.arange(
                B, dtype=torch.int32, device=dev), reduce="amax")
            g = last[:N].clamp(min=0).long()
            return [c[g] for c in (*a[1].values(), a[2])]

        hit = int(np.unique(slot.numpy()[slot.numpy() < N]).size)
        row = sum(v.element_size() for v in comp.values()) + 8
        if N == Y_SYMBOLS:
            res["K13b"] = dict(
                _timed(torch, lambda a=a: wx.frequent_last_lane(*a),
                       lambda a=a: wx.frequent_last_lane_plain(*a),
                       library=library),
                bound_ms=bound_ms(4 * B + 2 * N * row + hit * row),
                max_abs_err=0, bound_by="bytes")
        print(f"K13b N={N} ({hit} slots with a new lane) matches"
              + (f": {res['K13b']}" if N == Y_SYMBOLS else ""))

    # (e) app Y's int64 sorts
    from siddhi_tpu_torch.ops.groupby import hash_columns
    keys = hash_columns([comp["symbol"].to(dev)])
    for counter, k in (("K7 frequent key", keys),
                       ("K7 frequent match",
                        torch.where(torch.rand(keys[:Y_SYMBOLS].shape,
                                               device=dev) < 0.9,
                                    keys[:Y_SYMBOLS],
                                    torch.iinfo(torch.int64).max))):
        k = k.contiguous()
        got = search.stable_radix_argsort(k, counter=counter)
        check_equal(counter, got, search.stable_radix_argsort_plain(k))
        res[counter] = dict(
            _timed(torch,
                   lambda k=k, c=counter: search.stable_radix_argsort(
                       k, counter=c),
                   lambda k=k: search.stable_radix_argsort_plain(k),
                   library=lambda k=k: torch.sort(k, stable=True)),
            bound_ms=bound_ms(k.numel() * 12), max_abs_err=0,
            bound_by="bytes")
        print(f"{counter} L={k.numel()}: {res[counter]}")
    torch.cuda.synchronize()
    return res


def _now_of(ts, rounds: int, batch: int) -> np.ndarray:
    """Each event's round's clock under @app:playback: the round's last
    timestamp."""
    return np.repeat(ts[batch - 1::batch][:rounds], batch)


def oracle_sliding_frontiers(t_abs, ts, rounds: int, batch: int, E: int):
    """Output (row, timestamp) of a sliding expression window
    whose retained window after arrival i starts at t_abs[i] (nondecreasing,
    the condition monotone in the start): each arrival's CURRENT, then the
    rows it pops (oldest first, stamped with the round's clock); at most E
    pops a step, the rest carried to the next step's first arrival."""
    now = _now_of(ts, rounds, batch)
    expired = 0
    rows, stamps = [], []
    for r in range(rounds):
        lo = r * batch
        j = np.arange(batch)
        f = np.maximum(t_abs[lo:lo + batch] - expired, 0)
        f = np.minimum(np.minimum(f, lo + j + 1 - expired), E)
        f = np.maximum.accumulate(f)
        prev = np.r_[0, f[:-1]]
        n_pop = f - prev
        start = np.cumsum(1 + n_pop) - (1 + n_pop)  # each arrival's slot
        out = np.empty(batch + int(f[-1]), dtype=np.int64)
        is_exp = np.ones(out.shape[0], dtype=bool)
        out[start] = lo + j
        is_exp[start] = False
        pop_slot = np.nonzero(is_exp)[0]
        out[pop_slot] = expired + np.arange(int(f[-1]))
        rows.append(out)
        stamps.append(np.where(is_exp, now[lo], ts[out]))
        expired += int(f[-1])
    return np.concatenate(rows), np.concatenate(stamps)


def oracle_expression_batch(price, ts, rounds: int, batch: int,
                            budget: float):
    """Output (row, timestamp) of expressionBatch('sum(price) <
    budget', true): a flush covers the accumulated rows and the arrival
    that breaks the budget; at each flush the previous flush's rows come
    out expired, then its own current, all stamped with the clock of the
    round the breaking arrival came in. No single price reaches the budget
    here, so no flush is empty."""
    n = rounds * batch
    pre = np.r_[0.0, np.cumsum(price[:n])]
    now = _now_of(ts, rounds, batch)
    rows = []
    s, prev = 0, np.empty(0, dtype=np.int64)
    while True:
        j = int(np.searchsorted(pre, pre[s] + budget, side="left")) - 1
        if j >= n:
            break
        cur = np.arange(s, j + 1)
        rows.append((np.r_[prev, cur], now[j]))
        prev, s = cur, j + 1
    return (np.concatenate([r for r, _ in rows]),
            np.concatenate([np.full(r.shape[0], t) for r, t in rows]))


def _k3_hash_np(codes: np.ndarray) -> np.ndarray:
    """K3's hash of one int32 column, as int64."""
    with np.errstate(over="ignore"):
        x = codes.astype(np.int64).view(np.uint64)
        h = (np.uint64(0xCBF29CE484222325) ^ x) * np.uint64(0x100000001B3)
        h ^= h >> np.uint64(29)
    return h.view(np.int64)


def oracle_frequent(codes, ts, rounds: int, batch: int, n_slots: int,
                    support: float = 0.0, error: float = 0.0,
                    lossy: bool = False):
    """Output (row, timestamp) of frequent(N, symbol) or
    lossyFrequent(support, error, symbol), batch by batch as the window
    counts: K3's hash of the string code as the key; the batch's distinct
    keys in key order; tracked keys add their count; new keys take the
    free slots in slot order while they last; the arrivals of the rest
    decrement every counter, and counters at 0 free their slot (lossy: so
    do counters under error x total). CURRENT: the arrivals whose key is
    tracked afterwards (lossy: with count >= (support - error) x total);
    then EXPIRED: each freed slot that was occupied before the batch, its
    remembered row (the last arrival of its key), in slot order."""
    PAD, SCALE = np.iinfo(np.int64).max, 1_000_000
    keys_all = _k3_hash_np(codes)
    keys_all[keys_all == PAD] = PAD - 1
    N = n_slots
    slot_keys = np.full(N, PAD, dtype=np.int64)
    counts = np.zeros(N, dtype=np.int64)
    slot_row = np.full(N, -1, dtype=np.int64)
    total = 0
    rows = []
    for r in range(rounds):
        lane_rows = np.arange(r * batch, (r + 1) * batch)
        keys = keys_all[lane_rows]
        uk, uc = np.unique(keys, return_counts=True)
        where = {int(k): i for i, k in enumerate(slot_keys) if k != PAD}
        slot_of = np.array([where.get(int(k), N) for k in uk])
        tracked = slot_of < N
        counts1 = counts.copy()
        counts1[slot_of[tracked]] += uc[tracked]
        free = np.nonzero(slot_keys == PAD)[0]
        new = np.nonzero(~tracked)[0]
        placed, unplaced = new[:free.size], new[free.size:]
        keys1, counts2 = slot_keys.copy(), counts1.copy()
        keys1[free[:placed.size]] = uk[placed]
        counts2[free[:placed.size]] = uc[placed]
        occupied = keys1 != PAD
        counts3 = np.where(occupied,
                           np.maximum(counts2 - uc[unplaced].sum(), 0), 0)
        evicted = occupied & (counts3 == 0)
        keys2 = np.where(evicted, PAD, keys1)
        total1 = total + batch
        if lossy:
            low = (keys2 != PAD) & (counts3 * SCALE
                                    < int(error * SCALE) * total1)
            evicted |= low
            keys2 = np.where(low, PAD, keys2)
        where2 = {int(k): i for i, k in enumerate(keys2) if k != PAD}
        lane_slot = np.array([where2.get(int(k), N) for k in uk])[
            np.searchsorted(uk, keys)]
        tracked_lane = lane_slot < N
        new_row = slot_row.copy()
        np.maximum.at(new_row, lane_slot[tracked_lane],
                      lane_rows[tracked_lane])
        cur = tracked_lane
        if lossy:
            thr = int((support - error) * SCALE)
            cur = cur & (counts3[np.minimum(lane_slot, N - 1)] * SCALE
                         >= thr * total1)
        gone = np.nonzero(evicted & (slot_keys != PAD))[0]
        rows += [lane_rows[cur], slot_row[gone]]
        slot_keys, counts, slot_row, total = keys2, counts3, new_row, total1
    out = np.concatenate(rows)
    return out, ts[out]


def oracle_hopping(sym, x, ts, rounds: int, batch: int, C: int):
    """Rows and per-symbol running (sum(x), count) of app Z's hopping query:
    each round fires at the latest hop boundary b <= its clock and emits
    the ring's live rows (the last C arrivals) with b - window < ts <= b,
    in ring-slot order (row % C), those with x > 0, counted per symbol
    from the boundary's reset."""
    rows, sums, cnts = [], [], []
    for r in range(rounds):
        hi = (r + 1) * batch
        b = int(ts[hi - 1]) // Z_HOP_MS * Z_HOP_MS
        live = np.arange(max(hi - C, 0), hi)
        sel = live[(ts[live] > b - Z_WINDOW_MS) & (ts[live] <= b)]
        sel = sel[np.argsort(sel % C, kind="stable")]
        sel = sel[x[sel] > 0.0]
        order = np.lexsort((np.arange(sel.size), sym[sel]))
        ks = sym[sel][order]
        start = np.r_[True, ks[1:] != ks[:-1]]
        seg = np.cumsum(start) - 1
        cs = np.cumsum(x[sel][order])
        run = cs - (cs - x[sel][order])[start][seg]
        pos = np.arange(order.size)
        s_, c_ = np.empty(sel.size), np.empty(sel.size, dtype=np.int64)
        s_[order] = run
        c_[order] = pos - pos[start][seg] + 1
        rows.append(sel)
        sums.append(s_)
        cnts.append(c_)
    return np.concatenate(rows), np.concatenate(sums), np.concatenate(cnts)


def oracle_cron(ts, rounds: int, batch: int):
    """Every round crosses a one-second boundary, so each step fires: the
    previous round's rows expired, then its own current, in arrival
    order, with their own timestamps."""
    out = np.concatenate([np.arange(max(r - 1, 0) * batch, (r + 1) * batch)
                          for r in range(rounds)])
    return out, ts[out]


def check_rows(name: str, got, rows, stamps, columns: dict,
               names: tuple = ("symbol", "price", "volume")) -> int:
    """check_sliding on the oracle's rows (strings and longs exact, prices
    as the stored float32 values, exact). A stream callback sees the
    forwarded events as CURRENT: expired rows are told by their places and
    timestamps."""
    expect = [(c, columns[c][rows].tolist() if c == "symbol"
               else (columns[c][rows].astype(np.float32).astype(np.float64)
                     if c == "price" else columns[c][rows]),
               "exact" if c == "price" else False)
              for c in names]
    return check_sliding(name, got, stamps, expect)


def zipf_symbols(rng, n: int) -> np.ndarray:
    """Symbol indices drawn Zipf(Y_ZIPF), ranks past Y_SYMBOLS folded back
    into the pool."""
    return (rng.zipf(Y_ZIPF, n) - 1) % Y_SYMBOLS


def expr_app_events(rng, name: str, rounds: int = ROUNDS,
                    batch: int = BATCH, z_rate: int = Z_RATE):
    """(symbol index, price, volume, ts, symbol pool) of app `name`: W as
    app V's traffic; X with volumes 1-100 and prices on a 1/64 grid (every
    prefix sum exact in float64); Y over 10,000 symbols drawn Zipf(1.2);
    Z at z_rate events a second. Timestamps 1 ms apart but Z's."""
    n = rounds * batch
    pool = symbols(Y_SYMBOLS if name == "Y" else T_SYMBOLS)
    sym = (zipf_symbols(rng, n) if name == "Y"
           else rng.integers(0, T_SYMBOLS, n))
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    if name == "X":
        volume = rng.integers(1, 101, n).astype(np.int64)
        price = rng.integers(32, 6400, n) / 64.0
    step = np.arange(n, dtype=np.int64)
    ts = 1_700_000_000_000 + (step * 1000 // z_rate if name == "Z"
                              else step)
    return sym, price, volume, ts, pool


def expect_expr_app(name: str, sym, price, volume, ts, pool,
                    rounds: int = ROUNDS, batch: int = BATCH,
                    w_length: int = W_LENGTH, x_volume: int = X_VOLUME,
                    x_price: float = X_PRICE, y_slots: int = Y_SLOTS,
                    y_wide: int = Y_WIDE):
    """check(got: {stream: events}) -> events checked, against app
    `name`'s numpy oracles."""
    from siddhi_tpu_torch.ops.windows_extra import HoppingWindow
    n = rounds * batch
    columns = {"symbol": pool[sym], "price": price, "volume": volume}
    E = max(batch, 1024)  # the expression windows' expiry lanes a step

    def check(got: dict) -> int:
        if name == "W":
            t_abs = np.maximum(np.arange(n) + 1 - w_length, 0)
            return check_rows("W", got["OutStream"], *oracle_sliding_frontiers(
                t_abs, ts, rounds, batch, E), columns)
        if name == "X":
            pre = np.r_[0, np.cumsum(volume)]
            t_abs = np.searchsorted(pre, pre[1:] - x_volume, side="left")
            return (check_rows("X", got["OutStream"],
                                *oracle_sliding_frontiers(
                                    t_abs, ts, rounds, batch, E), columns)
                    + check_rows("X batch", got["BatchOut"],
                                  *oracle_expression_batch(
                                      price, ts, rounds, batch, x_price),
                                  columns))
        if name == "Y":
            _, first, inv = np.unique(sym, return_index=True,
                                      return_inverse=True)
            rank = np.empty_like(first)
            rank[np.argsort(first)] = np.arange(first.shape[0])
            codes = (rank[inv] + 1).astype(np.int32)  # first-seen order
            wide = oracle_frequent(codes, ts, rounds, batch, y_wide)
            # EXPIRED rows are the remembered rows of earlier rounds
            gone = wide[0] < np.maximum.accumulate(wide[0]) // batch * batch
            if gone.all() or not gone.any():
                raise Failure(f"app Y: frequent({y_wide})'s oracle holds "
                              f"{int((~gone).sum())} CURRENT and "
                              f"{int(gone.sum())} EXPIRED rows; both must "
                              "be non-empty")
            return (check_rows("Y", got["OutStream"], *oracle_frequent(
                        codes, ts, rounds, batch, y_slots), columns)
                    + check_rows("Y wide", got["WideOut"], *wide, columns)
                    + check_rows("Y lossy", got["LossyOut"],
                                  *oracle_frequent(
                                      codes, ts, rounds, batch,
                                      max(int(1.0 / Y_ERROR), 16),
                                      Y_SUPPORT, Y_ERROR, lossy=True),
                                  columns))
        C = HoppingWindow({}, batch, Z_WINDOW_MS, Z_HOP_MS).C
        # pol2Cart on the stored float32 price: float32 arithmetic
        x = (volume.astype(np.float32) * np.cos(np.deg2rad(
            price.astype(np.float32)))).astype(np.float64)
        rows, sx, cnt = oracle_hopping(sym, x, ts, rounds, batch, C)
        return (check_sliding("Z", got["OutStream"], ts[rows],
                              [("symbol", pool[sym[rows]].tolist(), False),
                               ("sx", sx, True), ("n", cnt, False)])
                + check_rows("Z cron", got["CronOut"],
                              *oracle_cron(ts, rounds, batch), columns))

    return check


def expression_apps(torch, rng, card: str, rounds: int = ROUNDS,
                    batch: int = BATCH) -> dict:
    """Apps W, X, Y and Z against their oracles, 0 host syncs a step for
    each query, each app's kernels launched; returns their launches."""
    k2b = ("K2b pack", "K2b fetch", "K2b append", "K2b gather")
    on_path = {"W": ("K1", *k2b, "K5b ungrouped", "K7 packed chunk"),
               "X": ("K1", *k2b, "K5b ungrouped", "K7 packed chunk",
                     "K13a sliding", "K13a batch"),
               "Y": ("K1", "K3", "K7 frequent key", "K7 frequent match",
                     "K13b"),
               "Z": ("K1",)}
    total = {}
    for name, (text, queries) in expr_app_plan().items():
        sym, price, volume, ts, pool = expr_app_events(rng, name, rounds,
                                                       batch)
        columns = {"symbol": pool[sym], "price": price, "volume": volume}
        rt, got, launches, elapsed, peak = run_app(
            torch, text, columns, ts, out_stream=tuple(queries.values()),
            rounds=rounds, batch=batch)
        n_out = expect_expr_app(name, sym, price, volume, ts, pool, rounds,
                                batch)(got)
        del got
        for k in on_path[name] + ("K12a",):
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        step_ms = {}
        for q in queries:
            syncs, step_ms[q] = measure_steps(torch, rt, columns, ts,
                                              fresh=True, rounds=rounds,
                                              batch=batch, query=q)
            if syncs:
                raise Failure(f"app {name}: query {q}'s step syncs with the "
                              f"host: {syncs}")
        report_app(name, ts.shape[0], n_out, elapsed,
                   sum(step_ms.values()), peak, launches, [], card,
                   rounds=rounds, batch=batch)
        print(f"app {name}: each query's step alone, ms per round: "
              f"{step_ms}")
        del rt
    return total

# --------------------------------------------------------------------------- #
# phases 22-23: K13c and the limiter / ORDER BY sites; apps AA and AB
# --------------------------------------------------------------------------- #

AA_SYMBOLS = 1_000
AA_RATE = 20_000  # app AA's events a second: a round spans ~6.5 s
AA_PERIOD_MS = 1_000  # every rate's period
AA_EVENTS = 100  # `output last every 100 events`
#: query 4's time window: 100,000 rows at AA_RATE, inside the sliding
#: ring's 131,072 (10 sec would overflow it and drop rows)
AA_TIME_MS = 5_000
AA_LENGTH = 4_096  # query 5's length window
AB_LENGTH = WINDOW  # app AB's lengthBatch
AB_OFFSET, AB_LIMIT = 2, 10


def limiter_app_plan(aa_length: int = AA_LENGTH,
                     ab_length: int = AB_LENGTH) -> dict:
    """name -> (app text, {query: output stream}) of apps AA and AB."""
    def q(name, source, select, rate, out):
        return (f"@info(name = '{name}')\nfrom TradeStream{source}\n"
                f"select {select}\n{rate}\ninsert into {out};\n")

    every = f"every {AA_PERIOD_MS // 1000} sec"
    return {
        "AA": (STOCK
               + q("last", "", "symbol, price",
                   f"output last every {AA_EVENTS} events", "LastOut")
               + q("all", "", "symbol, price, volume", f"output all {every}",
                   "AllOut")
               + q("first", "", "symbol, price", f"output first {every}",
                   "FirstOut")
               + q("grouped", f"#window.time({AA_TIME_MS // 1000} sec)",
                   "symbol, avg(price) as ap, count() as n",
                   f"group by symbol\noutput snapshot {every}",
                   "GroupedOut")
               + q("windowed", f"#window.length({aa_length})",
                   "symbol, price", f"output snapshot {every}",
                   "WindowedOut"),
               {"last": "LastOut", "all": "AllOut", "first": "FirstOut",
                "grouped": "GroupedOut", "windowed": "WindowedOut"}),
        "AB": (STOCK.replace("@app:playback\n", "")
               + q("bench", f"#window.lengthBatch({ab_length})",
                   "symbol, sum(volume) as total, avg(price) as ap",
                   f"group by symbol\norder by total desc, ap\n"
                   f"limit {AB_LIMIT} offset {AB_OFFSET}", "OutStream"),
               {"bench": "OutStream"}),
    }


def limiter_app_events(rng, name: str, rounds: int = ROUNDS,
                       batch: int = BATCH, aa_rate: int = AA_RATE):
    """(symbol index, price, volume, ts, symbol pool): AA over 1,000
    symbols at aa_rate events a second, AB on app A's feed (1,000,000
    symbols, 1 ms apart)."""
    n = rounds * batch
    if name == "AB":
        key, price, volume, ts = make_events(rng, False)
        key, price, volume, ts = key[:n], price[:n], volume[:n], ts[:n]
        return key - 1, price, volume, ts, symbols(N_KEYS)
    sym = rng.integers(0, AA_SYMBOLS, n)
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64) * 1000 // aa_rate
    return sym, price, volume, ts, symbols(AA_SYMBOLS)


def _first_seen_codes(sym: np.ndarray) -> np.ndarray:
    """The string table's codes: 1, 2, ... in first-seen order."""
    _, first, inv = np.unique(sym, return_index=True, return_inverse=True)
    rank = np.empty_like(first)
    rank[np.argsort(first)] = np.arange(first.shape[0])
    return rank[inv] + 1


def oracle_buffered(ts, rounds: int, batch: int, period: int, C: int):
    """`output all every <period>`: each step whose clock crosses into a
    newer bucket releases every buffered row (the newest C at most), in
    arrival order, with their own timestamps."""
    rows, bucket, flushed = [], 0, 0
    for r in range(rounds):
        end = (r + 1) * batch
        cur = int(ts[end - 1]) // period
        if cur > bucket:
            rows.append(np.arange(max(flushed, end - C), end))
            flushed = end
        bucket = max(bucket, cur)
    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    return rows, ts[rows]


def oracle_grouped_snapshot(sym, price32, ts, rounds: int, batch: int,
                            period: int, window: int):
    """`time(window)` avg/count by symbol, `output snapshot every period`:
    each step that crosses into a newer bucket (the first step only sets
    it) emits, in string-code order, every symbol's row at its last
    arrival before the step: the mean and count of its events in (ts -
    window, ts] up to that arrival. Returns (symbol index, ap, n, ts)."""
    n = ts.shape[0]
    codes = _first_seen_codes(sym)
    order = np.lexsort((np.arange(n), codes))  # by code, then arrival
    c_sorted, t_sorted = codes[order], ts[order]
    key_i = c_sorted * (n + 1) + order
    key_t = c_sorted * (2**45) + (t_sorted - ts[0])
    csum = np.r_[0.0, np.cumsum(price32[order].astype(np.float64))]
    start = np.searchsorted(c_sorted, np.arange(1, codes.max() + 1))
    g = np.arange(1, codes.max() + 1)
    out = ([], [], [], [])
    bucket = -1
    for r in range(rounds):
        now = int(ts[(r + 1) * batch - 1])
        b = now // period
        if bucket >= 0 and b > bucket:
            pos = np.searchsorted(key_i, g * (n + 1) + r * batch) - 1
            seen = pos >= start
            gs, ps = g[seen], pos[seen]
            lo = np.searchsorted(
                key_t, gs * (2**45) + (t_sorted[ps] - window - ts[0]),
                side="right")
            cnt = ps - lo + 1
            out[0].append(sym[order[ps]])
            out[1].append((csum[ps + 1] - csum[lo]) / cnt)
            out[2].append(cnt)
            out[3].append(np.full(gs.shape[0], now, np.int64))
        bucket = b if bucket < 0 else max(bucket, b)
    return tuple(np.concatenate(o) for o in out)


def oracle_windowed_snapshot(ts, rounds: int, batch: int, period: int,
                             length: int):
    """`length(L)` rows, `output snapshot every period`: each step that
    crosses into a newer bucket emits the window as of the bucket's
    start: the last L events stamped at or before it (an evicted event
    leaves at its evictor's timestamp), in arrival order, at the step's
    clock."""
    rows, stamps, bucket = [], [], -1
    for r in range(rounds):
        now = int(ts[(r + 1) * batch - 1])
        b = now // period
        if bucket >= 0 and b > bucket:
            hi = int(np.searchsorted(ts, b * period, side="right"))
            rows.append(np.arange(max(0, hi - length), hi))
            stamps.append(np.full(rows[-1].shape[0], now, np.int64))
        bucket = b if bucket < 0 else max(bucket, b)
    return np.concatenate(rows), np.concatenate(stamps)


def oracle_leaderboard(key, price32, volume, ts, batch: int, length: int,
                       offset: int = AB_OFFSET, limit: int = AB_LIMIT):
    """`lengthBatch(length)` sum(volume)/avg(price) by symbol, `order by
    total desc, ap limit .. offset ..`: each step's chunk holds the
    lengthBatch flushes it completes, every event with its running
    per-symbol values inside its flush; the chunk is sorted stably by
    (-total, ap) and rows [offset, offset + limit) come out (ap in
    float64: an order that float32 rounding could flip needs two equal
    totals with means within an ulp). Returns (event indices, totals,
    aps)."""
    n_flush = ts.shape[0] // length
    step = (np.arange(1, n_flush + 1) * length - 1) // batch
    rows, totals, aps = [], [], []
    for r in np.unique(step):
        ev = np.concatenate([np.arange(f * length, (f + 1) * length)
                             for f in np.nonzero(step == r)[0]])
        flush = ev // length
        k = key[ev]
        o = np.lexsort((np.arange(ev.shape[0]), k, flush))
        start = np.r_[True, (k[o][1:] != k[o][:-1])
                      | (flush[o][1:] != flush[o][:-1])]
        seg = np.cumsum(start) - 1
        tot = np.empty(ev.shape[0], np.int64)
        ap = np.empty(ev.shape[0])
        v, p = volume[ev][o], price32[ev][o].astype(np.float64)
        first = np.nonzero(start)[0][seg]
        cs, cp = np.cumsum(v), np.cumsum(p)
        tot[o] = cs - (cs - v)[start][seg]
        ap[o] = (cp - (cp - p)[start][seg]) / (np.arange(ev.shape[0])
                                                - first + 1)
        pick = np.lexsort((np.arange(ev.shape[0]), ap,
                           -tot))[offset:offset + limit]
        rows.append(ev[pick])
        totals.append(tot[pick])
        aps.append(ap[pick])
    return (np.concatenate(rows), np.concatenate(totals),
            np.concatenate(aps))


def expect_limiter_app(name: str, sym, price, volume, ts, pool,
                       rounds: int = ROUNDS, batch: int = BATCH,
                       aa_length: int = AA_LENGTH,
                       ab_length: int = AB_LENGTH):
    """check(got: {stream: events}) -> events checked, against app
    `name`'s numpy oracles."""
    from siddhi_tpu_torch.ops.ratelimit import BufferedLimiter
    n = rounds * batch
    columns = {"symbol": pool[sym], "price": price, "volume": volume}
    price32 = price.astype(np.float32)

    def check(got: dict) -> int:
        if name == "AB":
            rows, tot, ap = oracle_leaderboard(sym, price32, volume, ts,
                                               batch, ab_length)
            if rows.shape[0] == 0:
                raise Failure("app AB: the oracle emits nothing")
            return check_sliding("AB", got["OutStream"], ts[rows],
                                 [("symbol", pool[sym[rows]].tolist(),
                                   False), ("total", tot, False),
                                  ("ap", ap, True)])
        idx = np.arange(n)
        last = idx[(idx + 1) % AA_EVENTS == 0]
        bucket = ts // AA_PERIOD_MS
        first = idx[np.r_[True, bucket[1:] != bucket[:-1]]]
        C = BufferedLimiter({}, batch, time_ms=AA_PERIOD_MS).C
        g_sym, g_ap, g_n, g_ts = oracle_grouped_snapshot(
            sym, price32, ts, rounds, batch, AA_PERIOD_MS, AA_TIME_MS)
        n_checked = (
            check_rows("AA last", got["LastOut"], last, ts[last], columns,
                       ("symbol", "price"))
            + check_rows("AA all", got["AllOut"],
                         *oracle_buffered(ts, rounds, batch, AA_PERIOD_MS,
                                          C), columns)
            + check_rows("AA first", got["FirstOut"], first, ts[first],
                         columns, ("symbol", "price"))
            + check_sliding("AA grouped", got["GroupedOut"], g_ts,
                            [("symbol", pool[g_sym].tolist(), False),
                             ("ap", g_ap, True), ("n", g_n, False)])
            + check_rows("AA windowed", got["WindowedOut"],
                         *oracle_windowed_snapshot(ts, rounds, batch,
                                                   AA_PERIOD_MS, aa_length),
                         columns, ("symbol", "price")))
        if not all(got[o] for o in ("LastOut", "AllOut", "FirstOut",
                                    "GroupedOut", "WindowedOut")):
            raise Failure("app AA: a query emitted nothing")
        return n_checked

    return check


def limiter_kernel_phase(torch, rng, B: int = BATCH) -> dict:
    """K13c and the new sites of K7, K1, K5b and K13b against their plain
    versions on the card, bit for bit, at the shapes apps AA and AB give
    them: (a) K13c append of B lanes of ts, three columns, valid and type
    into a C = 2B ring across its end (`output all every 1 sec`), (b) its
    gather of C lanes from a wrapped start, (c) the snapshot ring's append
    of a 2B-lane sliding chunk, half CURRENT, into Cap = 2B (two columns),
    (d) its gather with n = the length window, (e) K7 on time-first bucket
    keys, (f) K7 on app AB's float64 order keys, (g) K1 on its chunk's
    valid lanes, (h) K5b's int32 rank of them, (i) K5b's int64 ordinal with
    a base, (j) K13b into G = 1024 group slots from a 2B-lane time-window
    chunk; with the same timings. The library calls: `ring[:, slot] =
    rows` and `index_select` on the ring's word matrix (the slots given),
    `torch.sort(stable=True)`, `torch.cumsum`, `scatter_reduce_(amax)`
    plus gathers."""
    from siddhi_tpu_torch.ops import groupby, search
    from siddhi_tpu_torch.ops import ratelimit as rl
    from siddhi_tpu_torch.ops import windows_extra as wx
    from siddhi_tpu_torch.ops.windows import LengthBatchWindow

    dev = torch.device("cuda")
    res = {}
    C = 2 * B

    def fields(n, full=True):
        f = {"symbol": torch.from_numpy(rng.integers(1, AA_SYMBOLS + 1, n)
                                        .astype(np.int32)),
             "price": torch.from_numpy(rng.uniform(1, 100, n)
                                       .astype(np.float32))}
        if full:
            f = {"__ts__": torch.from_numpy(
                     1_700_000_000_000 + np.arange(n, dtype=np.int64)),
                 **f,
                 "volume": torch.from_numpy(rng.integers(1, 1000, n)),
                 "__valid__": torch.from_numpy(rng.random(n) < 0.97),
                 "__types__": torch.zeros(n, dtype=torch.int8)}
        return {k: v.to(dev) for k, v in f.items()}

    def row_bytes(f):
        return sum(v.element_size() for v in f.values())

    def append_site(counter, src, ring, sel, appended, what):
        want, wn = rl.ring_append_plain({k: v.clone() for k, v in ring.items()},
                                        src, sel, appended)
        got, gn = rl.ring_append(ring, src, sel, appended, counter=counter)
        check_equal(f"{counter} count", gn, wn)
        for k in want:
            check_equal(f"{counter} {k}", got[k], want[k])
        n_sel = int(wn)
        slot = torch.remainder(torch.remainder(appended, C)
                               + torch.arange(n_sel, device=dev), C)
        words = -(-row_bytes(src) // 4)
        mat = torch.zeros((words, C), dtype=torch.int32, device=dev)
        rows = torch.ones((words, n_sel), dtype=torch.int32, device=dev)
        res[counter] = dict(
            _timed(torch,
                   lambda: rl.ring_append(ring, src, sel, appended,
                                          counter=counter),
                   lambda: rl.ring_append_plain(ring, src, sel, appended),
                   library=lambda: mat.__setitem__((slice(None), slot),
                                                   rows)),
            # the selection read, each selected row read and written once
            bound_ms=bound_ms(sel.numel() + 2 * n_sel * row_bytes(src)
                              + 16),
            max_abs_err=0, bound_by="bytes")
        print(f"{counter} {what} B={sel.numel()} into C={C} "
              f"({n_sel} selected): {res[counter]}")

    def gather_site(counter, ring, lo, n, ring_valid, what):
        args = (ring, torch.tensor(lo, device=dev),
                torch.tensor(n, device=dev), ring_valid)
        wc, wv = rl.ring_gather_plain(*args)
        gc, gv = rl.ring_gather(*args, counter=counter)
        check_equal(f"{counter} valid", gv, wv)
        for k in wc:
            check_equal(f"{counter} {k}", gc[k], wc[k])
        slot = torch.remainder(lo % C + torch.arange(C, device=dev), C)
        words = -(-(row_bytes(ring) + 1) // 4)
        mat = torch.zeros((words, C), dtype=torch.int32, device=dev)
        valid_bytes = 2 * C if ring_valid is not None else C
        res[counter] = dict(
            _timed(torch, lambda: rl.ring_gather(*args, counter=counter),
                   lambda: rl.ring_gather_plain(*args),
                   library=lambda: mat.index_select(1, slot)),
            # C rows read and written, the valid flags, lo and n
            bound_ms=bound_ms(2 * C * row_bytes(ring) + valid_bytes + 16),
            max_abs_err=0, bound_by="bytes")
        print(f"{counter} {what} C={C} lo={lo} n={n}: {res[counter]}")

    # (a), (b) the buffered ring of `output all every 1 sec`
    src, ring = fields(B), fields(C)
    sel = src["__valid__"] & (src["__types__"] == 0)
    append_site("K13c append", src, ring, sel,
                torch.tensor(C - B // 2, device=dev), "buffered")
    valid = ring.pop("__valid__")
    gather_site("K13c gather", ring, C - 1000, B, valid, "buffered")
    # (c), (d) the full-window snapshot ring of a length(4096) window
    src, ring = fields(C, full=False), fields(C, full=False)
    cur = torch.from_numpy(rng.random(C) < 0.5).to(dev)
    append_site("K13c snapshot append", src, ring, cur,
                torch.tensor(5 * C + 77, device=dev), "snapshot")
    gather_site("K13c snapshot gather", ring, 7 * C - 2000, AA_LENGTH, None,
                "snapshot")

    def sort_site(counter, keys, what, library_keys):
        keys = keys.to(dev)
        check_equal(counter, search.stable_radix_argsort(keys,
                                                         counter=counter),
                    search.stable_radix_argsort_plain(keys))
        lib = library_keys.to(dev)
        res[counter] = dict(
            _timed(torch,
                   lambda: search.stable_radix_argsort(keys,
                                                       counter=counter),
                   lambda: search.stable_radix_argsort_plain(keys),
                   library=lambda: torch.sort(lib, stable=True)),
            bound_ms=bound_ms(keys.numel() * 8 + keys.numel() * 4),
            max_abs_err=0, bound_by="bytes")
        print(f"{counter} {what} L={keys.numel()}: {res[counter]}")

    # (e) time-first: ~7 buckets a batch, a fifth of the lanes not newer
    bucket = 1_700_000_000 + np.arange(B) * 1000 // AA_RATE // 1000
    key = np.where(rng.random(B) < 0.8, bucket, 2**62)
    sort_site("K7 time-first", torch.from_numpy(key), "bucket keys",
              torch.from_numpy(key))
    # (f) app AB's chunk: float64 order keys of running sums, invalid +inf
    M = LengthBatchWindow({}, B, AB_LENGTH, expired_on=False).chunk_width
    valid = torch.from_numpy(rng.random(M) < 0.99).to(dev)
    tot = torch.from_numpy(rng.integers(1, 3000, M).astype(np.float64))
    k = torch.where(valid.cpu(), -tot, float("inf"))
    sort_site("K7 order by", search.float64_sort_key(k), "total desc",
              k)
    # (g) the stable partition of its valid lanes
    check_equal("K1 order by",
                search.stable_partition_order(valid, counter="K1 order by"),
                search.stable_partition_order_plain(valid))
    res["K1 order by"] = dict(
        _timed(torch,
               lambda: search.stable_partition_order(valid,
                                                     counter="K1 order by"),
               lambda: search.stable_partition_order_plain(valid),
               library=lambda: torch.sort((~valid).to(torch.int32),
                                          stable=True)),
        bound_ms=bound_ms(M + 4 * M), max_abs_err=0, bound_by="bytes")
    print(f"K1 order by L={M}: {res['K1 order by']}")

    # (h), (i) running counts
    def count_site(counter, mask, dt, base):
        got, gt = groupby.running_count(mask, counter=counter, base=base,
                                        dtype=dt)
        want = torch.cumsum(mask.to(dt), 0) + (0 if base is None else base)
        check_equal(counter, got, want.to(dt))
        check_equal(f"{counter} total", gt.reshape(1), want[-1:].to(dt))
        plain_state = groupby.GroupState(
            torch.zeros(1, dtype=dt, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
        zeros = torch.zeros_like(mask)
        epoch = torch.zeros((), dtype=torch.int32, device=dev)
        res[counter] = dict(
            _timed(torch,
                   lambda: groupby.running_count(mask, counter=counter,
                                                 base=base, dtype=dt),
                   lambda: groupby.ungrouped_scan_plain(
                       plain_state, mask.to(dt), mask, zeros, epoch),
                   library=lambda: torch.cumsum(mask.to(dt), 0)),
            bound_ms=bound_ms(mask.numel() * (1 + dt.itemsize)),
            max_abs_err=0, bound_by="bytes")
        print(f"{counter} L={mask.numel()} {dt}: {res[counter]}")

    count_site("K5b limit", valid, torch.int32, None)
    count_site("K5b ordinal", torch.from_numpy(rng.random(B) < 0.97)
               .to(dev), torch.int64, torch.tensor(5_000_000, device=dev))

    # (j) the grouped snapshot: the last live lane of each of G slots
    G = 1024
    L = C
    slot = np.where(rng.random(L) < 0.5, rng.integers(1, AA_SYMBOLS + 1, L),
                    G).astype(np.int32)
    comp = {"symbol": torch.from_numpy(slot.copy()).to(dev),
            "ap": torch.from_numpy(rng.uniform(1, 100, L)
                                   .astype(np.float32)).to(dev),
            "n": torch.from_numpy(rng.integers(1, 300, L)).to(dev)}
    old = {k: torch.zeros(G, dtype=v.dtype, device=dev)
           for k, v in comp.items()}
    a = [torch.from_numpy(slot).to(dev), comp,
         torch.ones(L, dtype=torch.bool, device=dev), old,
         torch.zeros(G, dtype=torch.bool, device=dev), G]
    gc, gp = wx.frequent_last_lane(*a, counter="K13b grouped snapshot")
    wc, wp = wx.frequent_last_lane_plain(*a)
    check_equal("K13b grouped snapshot present", gp, wp)
    for k in comp:
        check_equal(f"K13b grouped snapshot {k}", gc[k], wc[k])

    def library():
        last = torch.full((G + 1,), -1, dtype=torch.int32, device=dev)
        last.scatter_reduce_(0, a[0].long(), torch.arange(
            L, dtype=torch.int32, device=dev), reduce="amax")
        g = last[:G].clamp(min=0).long()
        return [c[g] for c in (*comp.values(), a[2])]

    hit = int(np.unique(slot[slot < G]).size)
    row = sum(v.element_size() for v in comp.values()) + 1
    res["K13b grouped snapshot"] = dict(
        _timed(torch,
               lambda: wx.frequent_last_lane(
                   *a, counter="K13b grouped snapshot"),
               lambda: wx.frequent_last_lane_plain(*a), library=library),
        bound_ms=bound_ms(4 * L + 2 * G * row + hit * row),
        max_abs_err=0, bound_by="bytes")
    print(f"K13b grouped snapshot L={L} into G={G} ({hit} slots hit): "
          f"{res['K13b grouped snapshot']}")
    torch.cuda.synchronize()
    return res


def limiter_apps(torch, rng, card: str, rounds: int = ROUNDS,
                 batch: int = BATCH) -> dict:
    """Apps AA and AB against their oracles, 0 host syncs a step for each
    query, each app's kernels launched; returns their launches."""
    on_path = {"AA": ("K5b ordinal", "K13c append", "K13c gather",
                      "K7 time-first", "K13b grouped snapshot",
                      "K13c snapshot append", "K13c snapshot gather",
                      "K5", "K2b pack"),
               "AB": ("K7 order by", "K1 order by", "K5b limit", "K5")}
    total = {}
    for name, (text, queries) in limiter_app_plan().items():
        sym, price, volume, ts, pool = limiter_app_events(rng, name, rounds,
                                                          batch)
        columns = {"symbol": pool[sym], "price": price, "volume": volume}
        rt, got, launches, elapsed, peak = run_app(
            torch, text, columns, ts, out_stream=tuple(queries.values()),
            rounds=rounds, batch=batch)
        n_out = expect_limiter_app(name, sym, price, volume, ts, pool,
                                   rounds, batch)(got)
        del got
        # the oracles hold every row: no window or snapshot ring overflowed
        for q in queries:
            for part in rt.query_runtimes[q].state:
                if int(getattr(part, "overflow", 0)):
                    raise Failure(f"app {name}: query {q} overflowed a "
                                  f"ring ({type(part).__name__})")
        for k in on_path[name] + ("K12a",):
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        step_ms = {}
        for q in queries:
            syncs, step_ms[q] = measure_steps(torch, rt, columns, ts,
                                              fresh=True, rounds=rounds,
                                              batch=batch, query=q)
            if syncs:
                raise Failure(f"app {name}: query {q}'s step syncs with the "
                              f"host: {syncs}")
        report_app(name, ts.shape[0], n_out, elapsed,
                   sum(step_ms.values()), peak, launches, [], card,
                   rounds=rounds, batch=batch)
        print(f"app {name}: each query's step alone, ms per round: "
              f"{step_ms}")
        del rt
    return total


# --------------------------------------------------------------------------- #
# phases 24-25: in-memory tables, table outputs, on-demand queries
# --------------------------------------------------------------------------- #

TABLE_C = 1 << 16  # config.default_table_capacity: both apps' tables
AC_SYMBOLS = 50_000  # symbols fed into app AC's table
AC_POOL = 60_000  # symbols the trades draw from: a sixth unknown
AC_FEED_BATCH = 16_384
AC_FEED_ROUNDS = 4
AC_SECTORS = 100
AD_IDS = 60_000
AD_BATCH = 8_192
AD_TXN_BATCHES = 8  # Txn batches a round
AD_CLOSE = 1_024  # ids a round's Close batch deletes
AD_KINDS = 10
AD_FLOOR = -5000.0  # the on-demand delete's balance bound

APP_AC = """@app:playback
define stream SymbolFeed (symbol string, sector int, weight double);
define stream TradeStream (symbol string, price double, volume long);
@PrimaryKey('symbol')
@Index('sector')
define table SymbolTable (symbol string, sector int, weight double);
from SymbolFeed insert into SymbolTable;
@info(name = 'known')
from TradeStream[TradeStream.symbol == SymbolTable.symbol in SymbolTable]
  select symbol, price, volume insert into KnownTrades;
@info(name = 'enrich')
from TradeStream as t join SymbolTable as s on t.symbol == s.symbol
  select t.symbol, s.sector, t.price * s.weight as wprice insert into Enriched;
"""
AC_QUERIES = ("from SymbolTable select sector, count() as n, avg(weight) as w "
              "group by sector",
              "from SymbolTable on sector == 7 select symbol, weight")

APP_AD = """@app:playback
define stream Txn (id long, amount double, kind int);
define stream Close (id long);
@PrimaryKey('id')
define table Account (id long, balance double, kind int);
@info(name = 'txn')
from Txn select id, amount as balance, kind
  update or insert into Account set Account.balance = Account.balance + balance, Account.kind = kind
  on Account.id == id;
@info(name = 'close')
from Close delete Account on Account.id == id;
"""
AD_QUERIES = ("from Account select kind, sum(balance) as total, count() as n "
              "group by kind",
              f"delete Account on Account.balance < {AD_FLOOR}")


def k13d_edge_cases(torch, rng, dev, B: int = AC_FEED_BATCH,
                    C: int = TABLE_C, C_big: int = 1 << 20,
                    B_big: int = 2048) -> dict:
    """K13d dedup cases, name -> (lane keys, row keys, lane valid, row
    valid), B lanes against C rows (60% live, 90% of the lanes valid)
    unless named: NaN, ±0.0 and ±inf in float32 and float64 keys, alone
    and beside an integer column; two int64 columns whose pairs swap; bool
    beside int64; int64 keys that differ only above bit 32; every lane one
    key, live in the table and not; repeats behind invalid lanes; B = 0,
    C = 0, B = 1; B_big lanes against C_big rows."""
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf])

    def draw(pool, n, p_special=0.0):
        out = pool[rng.integers(0, pool.size, n)]
        pick = rng.random(n) < p_special
        out[pick] = special[rng.integers(0, special.size, int(pick.sum()))]
        return out

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(lanes, rows, p_valid=0.9, p_live=0.6):
        nb, nc = lanes[0].shape[0], rows[0].shape[0]
        return ([t(a) for a in lanes], [t(r) for r in rows],
                t(rng.random(nb) < p_valid), t(rng.random(nc) < p_live))

    cases = {}
    fpool = rng.integers(-C, C, C // 2).astype(np.float64)
    for dt in (np.float32, np.float64):
        name = "float32" if dt == np.float32 else "float64"
        cases[f"{name} NaN ±0 ±inf"] = case(
            [draw(fpool, B, 0.2).astype(dt)], [draw(fpool, C, 0.2).astype(dt)])
    small = np.arange(8, dtype=np.float64)
    cases["float32 NaN ±0 beside int64"] = case(
        [draw(fpool, B, 0.3).astype(np.float32),
         draw(small, B).astype(np.int64)],
        [draw(fpool, C, 0.3).astype(np.float32),
         draw(small, C).astype(np.int64)])
    cases["float64 NaN ±0 beside int32"] = case(
        [draw(small, B, 0.4), draw(small, B).astype(np.int32)],
        [draw(small, C, 0.4), draw(small, C).astype(np.int32)])
    a, b = rng.integers(0, 300, (2, C))
    swap = rng.random(B) < 0.5
    pick = rng.integers(0, C, B)
    la = np.where(swap, b[pick], a[pick]) + rng.integers(0, 2, B) * 300
    lb = np.where(swap, a[pick], b[pick])
    cases["int64 pairs swapped"] = case([la, lb], [a, b])
    cases["bool beside int64"] = case(
        [rng.random(B) < 0.5, rng.integers(0, C // 4, B)],
        [rng.random(C) < 0.5, rng.integers(0, C // 4, C)])
    high = np.int64(0x5A5A5A5A)
    cases["int64 differing above bit 32"] = case(
        [high + (rng.integers(-C, C, B) << 32)],
        [high + (rng.integers(-C, C, C) << 32)])
    one = np.full(B, 77, np.int64)
    rows = rng.integers(1000, 10**9, C)
    rows[C // 3] = 77
    lk, rk, lv, rv = case([one], [rows])
    rv[C // 3] = True
    cases["every lane one key, live in the table"] = (lk, rk, lv, rv)
    rv = rv.clone()
    rv[C // 3] = False
    cases["every lane one key, not in the table"] = (lk, rk, lv, rv)
    keys = np.repeat(rng.integers(0, 10**12, -(-B // 3)), 3)[:B]
    lk, rk, lv, rv = case([keys], [rng.integers(10**12, 2 * 10**12, C)])
    lv[0::3] = t(rng.random(lv[0::3].shape[0]) < 0.5)  # first of each
    cases["repeats behind invalid lanes"] = (lk, rk, lv, rv)
    ipool = rng.integers(0, 4 * C, C)
    cases["B = 0"] = case([ipool[:0].astype(np.int32)],
                          [ipool.astype(np.int32)])
    cases["C = 0"] = case([draw(ipool, B).astype(np.int32)],
                          [ipool[:0].astype(np.int32)])
    cases["B = 1"] = case([ipool[:1].astype(np.int32)],
                          [ipool.astype(np.int32)], p_valid=1.0)
    bpool = rng.integers(0, 4 * C_big, C_big)
    cases[f"large C: B = {B_big} against C = {C_big}"] = case(
        [draw(bpool, B_big).astype(np.int32)], [bpool.astype(np.int32)])
    return cases


def place_edge_cases(torch, rng, dev) -> dict:
    """K13d place cases, name -> (state, batch columns, ts, valid, drop):
    B lanes (a tenth dropped) into C rows with a given number free, the
    staying lanes fitting exactly, overflowing by one, or into plenty of
    room across many blocks."""
    from siddhi_tpu_torch.core.table import TableState

    def build(B, C, n_free, fit):
        valid = rng.random(B) < 0.9
        drop = valid & (rng.random(B) < 0.1)
        n_stay = int((valid & ~drop).sum())
        if fit is not None:
            n_free = n_stay + fit
        free = np.zeros(C, bool)
        free[rng.choice(C, min(n_free, C), replace=False)] = True
        state = TableState(
            {"s": torch.from_numpy(rng.integers(0, 9, C).astype(np.int32))
             .to(dev),
             "p": torch.from_numpy(rng.random(C)).to(dev),
             "f": torch.from_numpy(rng.random(C) < 0.5).to(dev)},
            torch.arange(C, dtype=torch.int64, device=dev),
            torch.from_numpy(~free).to(dev))
        cols = {"s": torch.from_numpy(rng.integers(0, 9, B).astype(np.int32))
                .to(dev),
                "p": torch.from_numpy(rng.random(B)).to(dev),
                "f": torch.from_numpy(rng.random(B) < 0.5).to(dev)}
        ts = 10**12 + torch.arange(B, dtype=torch.int64, device=dev)
        return (state, cols, ts, torch.from_numpy(valid).to(dev),
                torch.from_numpy(drop).to(dev))

    return {"B = 1 into C = 64": build(1, 64, 10, None),
            "B = 0": build(0, 64, 10, None),
            "exact fit": build(AC_FEED_BATCH, TABLE_C, 0, 0),
            "one too many": build(AC_FEED_BATCH, TABLE_C, 0, -1),
            "B = 131072 into 2^18": build(BATCH, 1 << 18, 150_000, None)}


def check_place(name, tb, state, cols, ts, valid, drop) -> None:
    """place_rows on a copy of `state` against place_rows_plain: both
    counts, and the new state (the old one where it overflowed)."""
    from siddhi_tpu_torch.core.table import TableState
    from siddhi_tpu_torch.ops import search
    free = search.stable_partition_order_plain(~state.valid)
    want, wcounts = tb.place_rows_plain(state, cols, ts, valid, drop, free)
    copy = TableState({k: v.clone() for k, v in state.cols.items()},
                      state.ts.clone(), state.valid.clone())
    got, gcounts = tb.place_rows(copy, cols, ts, valid, drop, free)
    check_equal(f"{name} counts", gcounts, wcounts)
    expect = state if int(wcounts[0]) else want
    for k in state.cols:
        check_equal(f"{name} {k}", got.cols[k], expect.cols[k])
    check_equal(f"{name} ts", got.ts, expect.ts)
    check_equal(f"{name} valid", got.valid, expect.valid)


def k13e_eq_edge_cases(torch, rng, dev, B: int = 2048, C: int = 8192,
                       ad: bool = True) -> dict:
    """K13e equality-route cases, name -> (lane keys, row keys, lane valid,
    row valid), B lanes against C rows (70% live, 85% of the lanes valid)
    unless named: NaN, ±0.0 and ±inf in float32 and float64 keys; int64
    keys that differ only above bit 32; string codes (0 the null code); a
    two-column and a four-column key; bool beside int32; repeated keys in
    the batch (the last lane wins); invalid lanes; dead rows; B = 1; no
    live row; no lane valid; every row one key; with `ad`, app AD's shape
    (8,192 ids over 60,000 against 65,536 rows, 50,000 live)."""
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(lanes, rows, p_valid=0.85, p_live=0.7):
        nb, nc = lanes[0].shape[0], rows[0].shape[0]
        return ([t(a) for a in lanes], [t(r) for r in rows],
                t(rng.random(nb) < p_valid), t(rng.random(nc) < p_live))

    def pool(n, k):
        return rng.integers(0, k, n)

    cases = {}
    for dt in (np.float32, np.float64):
        name = "float32" if dt == np.float32 else "float64"
        vals = np.concatenate([special, np.arange(32.0)]).astype(dt)
        cases[f"{name} NaN ±0 ±inf"] = case(
            [vals[pool(B, vals.size)]], [vals[pool(C, vals.size)]])
    high = np.int64(0x12345678)
    cases["int64 differing above bit 32"] = case(
        [high + (rng.integers(-64, 64, B) << 32)],
        [high + (rng.integers(-64, 64, C) << 32)])
    cases["string codes"] = case([pool(B, 40).astype(np.int32)],
                                 [pool(C, 40).astype(np.int32)])
    cases["two columns"] = case(
        [pool(B, 30), special[pool(B, 5)].astype(np.float32)],
        [pool(C, 30), special[pool(C, 5)].astype(np.float32)])
    cases["four columns"] = case(
        [pool(B, 4), pool(B, 3).astype(np.int32), pool(B, 2) == 1,
         pool(B, 3).astype(np.float64)],
        [pool(C, 4), pool(C, 3).astype(np.int32), pool(C, 2) == 1,
         pool(C, 3).astype(np.float64)])
    cases["bool beside int32"] = case(
        [pool(B, 2) == 1, pool(B, 50).astype(np.int32)],
        [pool(C, 2) == 1, pool(C, 50).astype(np.int32)])
    cases["repeats in the batch"] = case([pool(B, 16)], [pool(C, 64)],
                                         p_valid=1.0)
    cases["invalid lanes"] = case([pool(B, C)], [rng.permutation(C)],
                                  p_valid=0.2)
    cases["dead rows"] = case([pool(B, C)], [rng.permutation(C)],
                              p_live=0.05)
    cases["B = 1"] = case([pool(1, 8)], [pool(C, 8)], p_valid=1.0)
    cases["no live row"] = case([pool(B, 8)], [pool(C, 8)], p_live=0.0)
    cases["no lane valid"] = case([pool(B, 8)], [pool(C, 8)], p_valid=0.0)
    cases["every row one key"] = case([pool(B, 4)], [np.full(C, 2)])
    if ad:
        ids = rng.permutation(AD_IDS)[:50_000].astype(np.int64)
        rows = np.concatenate([ids, rng.integers(0, AD_IDS,
                                                 TABLE_C - ids.size)])
        live = np.arange(TABLE_C) < ids.size
        cases["app AD's shape"] = (
            [t(rng.integers(0, AD_IDS, AD_BATCH))], [t(rows)],
            t(rng.random(AD_BATCH) < 0.98), t(live))
    return cases


def k13e_mask_edge_cases(torch, rng, dev, B: int = 2048,
                         C: int = 8192) -> dict:
    """K13e mask-route cases, name -> (condition, lane valid, row valid):
    a [B, C] condition (sparse, dense, C not a multiple of 16, a
    transposed view, a view one column in), [B, 1], [C] (table-only), a
    host scalar and a card scalar, no lane valid vector (`in T`), every
    lane invalid, no live row, B = 1, C = 1."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def valids(nb, nc, p_valid=0.85, p_live=0.7):
        return t(rng.random(nb) < p_valid), t(rng.random(nc) < p_live)

    cases = {}
    cases["[B, C] sparse"] = (t(rng.random((B, C)) < 0.0005),
                              *valids(B, C))
    cases["[B, C] dense"] = (t(rng.random((B, C)) < 0.5), *valids(B, C))
    cases["[B, C], C = 1000"] = (t(rng.random((B, 1000)) < 0.01),
                                 *valids(B, 1000))
    cases["[B, C] transposed view"] = (
        t(rng.random((C, B)) < 0.01).t(), *valids(B, C))
    wide = t(rng.random((B, C + 1)) < 0.01)
    cases["[B, C] one column in"] = (wide[:, 1:], *valids(B, C))
    cases["[B, 1]"] = (t(rng.random((B, 1)) < 0.3), *valids(B, C))
    cases["[C] table-only"] = (t(rng.random(C) < 0.3), *valids(B, C))
    cases["host scalar true"] = (torch.tensor(True), *valids(B, C))
    cases["card scalar false"] = (torch.tensor(False, device=dev),
                                  *valids(B, C))
    cases["no lane valid vector"] = (t(rng.random((B, C)) < 0.001), None,
                                     valids(B, C)[1])
    cases["every lane invalid"] = (t(rng.random((B, C)) < 0.01),
                                   *valids(B, C, p_valid=0.0))
    cases["no live row"] = (t(rng.random((B, C)) < 0.01),
                            *valids(B, C, p_live=0.0))
    cases["B = 1"] = (t(rng.random((1, C)) < 0.01), *valids(1, C))
    cases["C = 1"] = (t(rng.random((B, 1)) < 0.5), *valids(B, 1, p_live=1))
    return cases


def table_edge_phase(torch, rng) -> None:
    """Phase 24's edges: K13d dedup at k13d_edge_cases against its plain
    version, bit for bit, one launch a call (none at B = 0), also with two
    tables of different C called alternately on one stream; K13d place at
    place_edge_cases against its plain version (state and counts); K13e's
    two routes at k13e_eq_edge_cases and k13e_mask_edge_cases."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core import table as tb
    dev = torch.device("cuda")
    cases = k13d_edge_cases(torch, rng, dev)
    big = [n for n in cases if n.startswith("large C")][0]
    order = list(cases) + [big, "float32 NaN ±0 ±inf", big, "B = 1"]
    seen = {}
    for name in order:
        lane, row, lv, rv = cases[name]
        kernels.reset_launch_counts()
        got = tb.pk_duplicates(lane, row, lv, rv)
        want_launches = 1 if lv.shape[0] else 0
        if kernels.LAUNCHES["K13d dedup"] != want_launches:
            raise Failure(f"K13d dedup edge {name}: "
                          f"{kernels.LAUNCHES['K13d dedup']} launches, "
                          f"{want_launches} expected")
        check_equal(f"K13d dedup edge {name}", got,
                    tb.pk_duplicates_plain(lane, row, lv, rv))
        seen[name] = int(got.sum())
    print(f"K13d dedup edges, lanes dropped (bit for bit; sizes "
          f"alternating on one stream): {seen}")
    for name in ("every lane one key, live in the table",
                 "every lane one key, not in the table",
                 "repeats behind invalid lanes"):
        if not seen[name]:
            raise Failure(f"K13d dedup edge {name}: no lane dropped")
    for name, case in place_edge_cases(torch, rng, dev).items():
        kernels.reset_launch_counts()
        check_place(f"K13d place edge {name}", tb, *case)
        if kernels.LAUNCHES["K13d place"] != 1:
            raise Failure(f"K13d place edge {name}: "
                          f"{kernels.LAUNCHES['K13d place']} launches, one "
                          "expected")
    print("K13d place edges: state and counts bit for bit, one launch a "
          "call")
    # the dedup at app AD's shape: an update-or-insert batch's unmatched
    # ids (B = 8,192 over 60,000 ids) against 50,000 live accounts
    ids = rng.permutation(AD_IDS)[:min(50_000, TABLE_C - TABLE_C // 8)] \
        .astype(np.int64)
    rows = np.concatenate([ids, rng.integers(0, AD_IDS, TABLE_C - ids.size)])
    live = np.arange(TABLE_C) < ids.size
    lanes = rng.integers(0, AD_IDS, AD_BATCH)
    lane = [torch.from_numpy(lanes).to(dev)]
    row = [torch.from_numpy(rows).to(dev)]
    lv = torch.from_numpy(~np.isin(lanes, ids)).to(dev)
    rv = torch.from_numpy(live).to(dev)
    check_equal("K13d dedup at AD's shape", tb.pk_duplicates(lane, row, lv, rv),
                tb.pk_duplicates_plain(lane, row, lv, rv))
    t = _timed(torch, lambda: tb.pk_duplicates(lane, row, lv, rv),
               lambda: tb.pk_duplicates_plain(lane, row, lv, rv))
    t["bound_ms"] = bound_ms(9 * AD_BATCH + 9 * TABLE_C + AD_BATCH)
    print(f"K13d dedup at app AD's shape, B={AD_BATCH} ({int(lv.sum())} "
          f"valid) against C={TABLE_C} ({ids.size} live): {t}")
    # K13e: both routes' cases, one launch a call, the routes and their
    # sizes alternating on one stream (one workspace)
    eq = k13e_eq_edge_cases(torch, rng, dev)
    mk = k13e_mask_edge_cases(torch, rng, dev)
    order = ([("eq", n) for n in eq] + [("mask", n) for n in mk]
             + [("eq", "app AD's shape"), ("mask", "[B, C] dense"),
                ("eq", "B = 1"), ("mask", "C = 1"), ("eq", "app AD's shape")])
    matched = {}
    for route, name in order:
        kernels.reset_launch_counts()
        if route == "eq":
            lane, row, lv, rv = eq[name]
            got = tb.last_match_eq(lane, row, lv, rv)
            want = tb.last_match_eq_plain(lane, row, lv, rv)
            counter = "K13e eq"
        else:
            cond, lv, rv = mk[name]
            got = tb.last_match(cond, lv, rv)
            want = tb.last_match_mask_plain(cond, lv, rv)
            counter = "K13e"
        if kernels.LAUNCHES[counter] != 1:
            raise Failure(f"K13e {route} edge {name}: "
                          f"{kernels.LAUNCHES[counter]} launches, one "
                          "expected")
        for part, g, w in zip(("has", "b_star", "ev_matched"), got, want):
            check_equal(f"K13e {route} edge {name} {part}", g, w)
        matched[f"{route}: {name}"] = int(got[0].sum())
    print("K13e edges, rows matched (bit for bit, one launch a call, "
          f"routes and sizes alternating on one stream): {matched}")


def table_kernel_phase(torch, rng, B: int = AC_FEED_BATCH, C: int = TABLE_C,
                       B_mask: int = AD_BATCH, rng13e=None) -> dict:
    """K13d, K13e and the table sites of K1, K7 and K13b against their
    plain versions on the card, bit for bit, at apps AC's and AD's
    shapes, with the same timings. K13e's valid vectors, table-only
    condition and equality keys draw from `rng13e`, so `rng` leaves this
    phase as it did before they were added (the apps after it keep their
    feeds)."""
    rng13e = rng13e if rng13e is not None else np.random.default_rng(13)
    from siddhi_tpu_torch.core import table as tb
    from siddhi_tpu_torch.core.table import TableState
    from siddhi_tpu_torch.ops import search
    from siddhi_tpu_torch.ops import windows_extra as wx

    dev = torch.device("cuda")
    res = {}
    n_live = min(40_000, C * 5 // 8)
    live = np.zeros(C, bool)
    live[rng.choice(C, n_live, replace=False)] = True
    codes = rng.permutation(4 * C).astype(np.int32)[:C]  # distinct keys

    def state_of():
        return TableState(
            {"symbol": torch.from_numpy(codes).to(dev),
             "sector": torch.from_numpy(rng.integers(0, AC_SECTORS, C)
                                        .astype(np.int32)).to(dev),
             "weight": torch.from_numpy(rng.random(C).astype(np.float32))
             .to(dev)},
            torch.arange(C, dtype=torch.int64, device=dev),
            torch.from_numpy(live).to(dev))

    state = state_of()
    # the feed: a fifth repeats a live row's key, a fifth a key earlier in
    # the batch
    bkey = rng.integers(0, 4 * C, B).astype(np.int32)
    pick = rng.random(B)
    bkey = np.where(pick < 0.2, rng.choice(codes[live], B), bkey)
    earlier = np.maximum(np.arange(B) - rng.integers(1, 50, B), 0)
    bkey = np.where(pick > 0.8, bkey[earlier], bkey)
    bcols = {"symbol": torch.from_numpy(bkey).to(dev),
             "sector": torch.from_numpy(rng.integers(0, AC_SECTORS, B)
                                        .astype(np.int32)).to(dev),
             "weight": torch.from_numpy(rng.random(B).astype(np.float32))
             .to(dev)}
    bts = torch.arange(B, dtype=torch.int64, device=dev) + 10**12
    bvalid = torch.from_numpy(rng.random(B) < 0.98).to(dev)
    lane, row = [bcols["symbol"]], [state.cols["symbol"]]

    # (a) the dedup
    drop = tb.pk_duplicates(lane, row, bvalid, state.valid)
    check_equal("K13d dedup", drop,
                tb.pk_duplicates_plain(lane, row, bvalid, state.valid))

    def masks():
        a, r = lane[0], row[0]
        eq = (a[:, None] == r[None, :]) & state.valid[None, :]
        eq_b = (a[:, None] == a[None, :]) & torch.tril(
            torch.ones((B, B), dtype=torch.bool, device=dev), -1)
        return eq.any(1) | (eq_b & bvalid[None, :]).any(1)

    res["K13d dedup"] = dict(
        _timed(torch, lambda: tb.pk_duplicates(lane, row, bvalid,
                                               state.valid),
               lambda: tb.pk_duplicates_plain(lane, row, bvalid,
                                              state.valid),
               library=masks),
        # the keys and valid flags read once, the drop flags written
        bound_ms=bound_ms(5 * B + 5 * C + B), max_abs_err=0,
        bound_by="bytes")
    print(f"K13d dedup B={B} against C={C} ({n_live} live, "
          f"{int(drop.sum())} dropped): {res['K13d dedup']}")

    # (b) the placement, then once more overflowing
    free = search.stable_partition_order(~state.valid,
                                         counter="K1 table free")
    check_equal("K1 table free", free,
                search.stable_partition_order_plain(~state.valid))

    def fresh():
        return TableState({k: v.clone() for k, v in state.cols.items()},
                          state.ts.clone(), state.valid.clone())

    want, wcounts = tb.place_rows_plain(state, bcols, bts, bvalid, drop,
                                        free)
    got, gcounts = tb.place_rows(fresh(), bcols, bts, bvalid, drop, free)
    check_equal("K13d place counts", gcounts, wcounts)
    for k in want.cols:
        check_equal(f"K13d place {k}", got.cols[k], want.cols[k])
    check_equal("K13d place ts", got.ts, want.ts)
    check_equal("K13d place valid", got.valid, want.valid)
    full = torch.ones(C, dtype=torch.bool, device=dev)
    full[:B // 4] = False  # fewer free rows than staying lanes
    over = TableState(dict(state.cols), state.ts, full)
    ofree = search.stable_partition_order_plain(~full)
    copy = TableState({k: v.clone() for k, v in state.cols.items()},
                      state.ts.clone(), full.clone())
    _, ocounts = tb.place_rows(copy, bcols, bts, bvalid, drop, ofree)
    _, wo = tb.place_rows_plain(over, bcols, bts, bvalid, drop, ofree)
    check_equal("K13d place overflow counts", ocounts, wo)
    if int(ocounts[0]) == 0:
        raise Failure("K13d place: the overflow case did not overflow")
    for k in state.cols:
        check_equal(f"K13d place overflow {k}", copy.cols[k], state.cols[k])
    check_equal("K13d place overflow valid", copy.valid, full)
    n_ins = int((bvalid & ~drop).sum())
    slots = free[:n_ins].long()
    src = [bcols[k][:n_ins] for k in state.cols]
    work = fresh()

    def reset():  # untimed: the placement writes the table in place
        for k, v in state.cols.items():
            work.cols[k].copy_(v)
        work.ts.copy_(state.ts)
        work.valid.copy_(state.valid)

    res["K13d place"] = dict(
        _timed(torch,
               lambda: tb.place_rows(work, bcols, bts, bvalid, drop, free),
               lambda: tb.place_rows_plain(state, bcols, bts, bvalid, drop,
                                           free),
               library=lambda: [d.index_put_((slots,), s_) for d, s_ in
                                zip(work.cols.values(), src)],
               reset=reset),
        # the flags, the staying rows read and written, their free slots
        bound_ms=bound_ms(2 * B + C + n_ins * (4 + 2 * (4 + 4 + 4 + 8) + 1)),
        max_abs_err=0, bound_by="bytes")
    print(f"K13d place {n_ins} lanes into C={C}: {res['K13d place']}")
    res["K1 table free"] = dict(
        _timed(torch,
               lambda: search.stable_partition_order(
                   ~state.valid, counter="K1 table free"),
               lambda: search.stable_partition_order_plain(~state.valid),
               library=lambda: torch.sort(state.valid.to(torch.int32),
                                          stable=True)),
        bound_ms=bound_ms(C + 4 * C), max_abs_err=0, bound_by="bytes")
    print(f"K1 table free C={C}: {res['K1 table free']}")

    # (c) K13e's mask route at app AD's [B, C] (each event equal to at
    # most one row) with both valid vectors, then a table-only condition,
    # then the equality route at AD's shape (ids over AD_IDS)
    ids = rng.permutation(C).astype(np.int64)
    ev = torch.from_numpy(rng.integers(0, C + C // 2, B_mask)).to(dev)
    rows = torch.from_numpy(ids).to(dev)
    lv = torch.from_numpy(rng13e.random(B_mask) < 0.98).to(dev)
    rv = state.valid
    mask = ev[:, None] == rows[None, :]
    got = tb.last_match(mask, lv, rv)
    for name, g, w in zip(("has", "b_star", "ev_matched"), got,
                          tb.last_match_mask_plain(mask, lv, rv)):
        check_equal(f"K13e {name}", g, w)
    masked = mask & lv[:, None] & rv[None, :]

    def library13e():
        return (masked.any(0),
                torch.argmax(masked.flip(0).to(torch.uint8), 0),
                masked.any(1))

    out_bytes = 5 * C + B_mask
    # the condition's bytes the function needs: a valid lane's at a live
    # row (the whole mask: bound_ms(B_mask * C + ...))
    pairs = int(lv.sum()) * n_live
    res["K13e"] = dict(
        _timed(torch, lambda: tb.last_match(mask, lv, rv),
               lambda: tb.last_match_mask_plain(mask, lv, rv),
               library=library13e),
        bound_ms=bound_ms(pairs + B_mask + C + out_bytes), max_abs_err=0,
        bound_by="bytes")
    res["K13e"]["whole_mask_bound_ms"] = bound_ms(B_mask * C + B_mask + C
                                                  + out_bytes)
    print(f"K13e mask route [{B_mask} x {C}] with valid vectors "
          f"({int(got[0].sum())} rows matched): {res['K13e']}")
    del mask, masked
    cond = torch.from_numpy(rng13e.uniform(-9000, 9000, C)
                            .astype(np.float32)).to(dev) < AD_FLOOR
    got = tb.last_match(cond, lv, rv)
    for name, g, w in zip(("has", "b_star", "ev_matched"), got,
                          tb.last_match_mask_plain(cond, lv, rv)):
        check_equal(f"K13e table-only {name}", g, w)
    res["K13e (a table-only condition)"] = dict(
        _timed(torch, lambda: tb.last_match(cond, lv, rv),
               lambda: tb.last_match_mask_plain(cond, lv, rv)),
        bound_ms=bound_ms(C + B_mask + C + out_bytes), max_abs_err=0,
        bound_by="bytes")
    print(f"K13e mask route, a table-only [C] condition read as [1, {C}] "
          f"for B={B_mask} ({int(got[0].sum())} rows): "
          f"{res['K13e (a table-only condition)']}")
    lane, row, elv, erv = k13e_eq_edge_cases(
        torch, rng13e, dev, B=2, C=2)["app AD's shape"]
    got = tb.last_match_eq(lane, row, elv, erv)
    for name, g, w in zip(("has", "b_star", "ev_matched"), got,
                          tb.last_match_eq_plain(lane, row, elv, erv)):
        check_equal(f"K13e eq {name}", g, w)

    def mask_path():  # the route the equality replaces: the [B, C] mask
        return tb.last_match((lane[0][:, None] == row[0][None, :])
                             & elv[:, None] & erv[None, :])

    res["K13e eq"] = dict(
        _timed(torch, lambda: tb.last_match_eq(lane, row, elv, erv),
               lambda: tb.last_match_eq_plain(lane, row, elv, erv)),
        bound_ms=bound_ms(9 * AD_BATCH + 9 * C + 5 * C + AD_BATCH),
        max_abs_err=0, bound_by="bytes")
    res["K13e eq"]["mask_path_ms"] = device_ms(torch, mask_path)
    print(f"K13e equality route at app AD's shape, B={AD_BATCH} ids "
          f"({int(elv.sum())} valid) against C={C} ({int(erv.sum())} live, "
          f"{int(got[0].sum())} rows matched): {res['K13e eq']}")

    # (d) K7 on the index keys: the sector column, invalid rows at max
    sector = torch.where(state.valid, state.cols["sector"],
                         torch.iinfo(torch.int32).max)
    check_equal("K7 table index", tb.sorted_index(sector),
                torch.sort(sector).values)
    k64 = sector.to(torch.int64)
    res["K7 table index"] = dict(
        _timed(torch, lambda: tb.sorted_index(sector),
               lambda: search.stable_radix_argsort_plain(k64),
               library=lambda: torch.sort(sector)),
        bound_ms=bound_ms(4 * C + 4 * C), max_abs_err=0, bound_by="bytes")
    print(f"K7 table index C={C}: {res['K7 table index']}")

    # (e) K13b: the last lane of each group slot of an on-demand chunk
    K = GROUP_CAP
    slot = torch.from_numpy(np.where(live, rng.integers(0, AC_SECTORS, C),
                                     K).astype(np.int32)).to(dev)
    check_equal("K13b final per group",
                wx.last_lane_per_slot(slot, K,
                                      counter="K13b final per group"),
                wx.last_lane_per_slot_plain(slot, K))

    def library13b():
        last = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
        return last.scatter_reduce_(0, slot.long(), torch.arange(
            C, dtype=torch.int32, device=dev), reduce="amax")

    res["K13b final per group"] = dict(
        _timed(torch,
               lambda: wx.last_lane_per_slot(
                   slot, K, counter="K13b final per group"),
               lambda: wx.last_lane_per_slot_plain(slot, K),
               library=library13b),
        # the slots read, the K + 1 last lanes written
        bound_ms=bound_ms(4 * C + 4 * (K + 1)), max_abs_err=0,
        bound_by="bytes")
    print(f"K13b final per group C={C} into K={K}: "
          f"{res['K13b final per group']}")
    torch.cuda.synchronize()
    return res


def ac_events(rng, n_symbols: int = AC_SYMBOLS, pool: int = AC_POOL,
              feed_batch: int = AC_FEED_BATCH,
              feed_rounds: int = AC_FEED_ROUNDS, rounds: int = ROUNDS,
              batch: int = BATCH):
    """App AC's feed (every symbol once, then repeats, shuffled) and
    trades over a pool a sixth larger."""
    L = feed_rounds * feed_batch
    feed = rng.permutation(np.concatenate([
        np.arange(n_symbols), rng.integers(0, n_symbols, L - n_symbols)]))
    sector = rng.integers(0, AC_SECTORS, L).astype(np.int32)
    weight = rng.uniform(0.5, 2.0, L)
    n = rounds * batch
    sym = rng.integers(0, pool, n)
    price = rng.uniform(1.0, 100.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    t0 = 1_700_000_000_000
    feed_ts = t0 + np.arange(L, dtype=np.int64)
    ts = t0 + L + np.arange(n, dtype=np.int64)
    names = np.array([f"S{i}" for i in range(pool)], dtype=object)
    return names, (feed, sector, weight, feed_ts), (sym, price, volume, ts)


def oracle_ac(feed, sector, weight, sym, price):
    """The table (slots in first-occurrence order) and app AC's outputs:
    KnownTrades lanes, each known trade's (sector, price x weight), the
    per-sector (last slot, count, mean weight) and sector 7's slots."""
    _, first = np.unique(feed, return_index=True)
    order = np.sort(first)
    t_sym = feed[order]
    t_sector = sector[order]
    t_weight = weight[order].astype(np.float32)
    slot_of = np.full(max(int(sym.max()), int(feed.max())) + 1, -1)
    slot_of[t_sym] = np.arange(t_sym.shape[0])
    known = slot_of[sym] >= 0
    s = slot_of[sym[known]]
    wprice = price[known].astype(np.float32) * t_weight[s]
    groups = []
    for sec in np.unique(t_sector):
        idx = np.nonzero(t_sector == sec)[0]
        groups.append((int(idx[-1]), int(sec), idx.size,
                       float(t_weight[idx].astype(np.float64).mean())))
    groups.sort()
    return (t_sym, t_sector, t_weight, known, t_sector[s], wprice, groups,
            np.nonzero(t_sector == 7)[0])


def _batches(rt, stream: str, columns: dict, ts, batch: int) -> list:
    from siddhi_tpu_torch.core.event import EventBatch
    j = rt.junctions[stream]
    out = []
    for s in range(0, ts.shape[0], batch):
        n = min(batch, ts.shape[0] - s)
        cols = j.codec.encode_columns(
            {k: v[s:s + n] for k, v in columns.items()}, n)
        out.append((EventBatch.from_numpy(ts[s:s + n], cols, n,
                                          j.ctx.device),
                    int(ts[s + n - 1])))
    return out


def timed_steps(torch, fn, items, expect_syncs: int, what: str):
    """(mean ms of fn(item) over `items`, the card synchronised around the
    whole run; the first call's host syncs, which must number
    `expect_syncs`)."""
    torch.cuda.synchronize()
    _, syncs = call_watching_syncs(torch, lambda: fn(items[0]))
    if len(syncs) != expect_syncs:
        raise Failure(f"{what}: {len(syncs)} host syncs in a step, "
                      f"{expect_syncs} expected: {syncs}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in items:
        fn(it)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(items) * 1e3, syncs


#: launches of one table insert: the dedup, the free rows, the placement
INSERT_LAUNCHES = {"K13d dedup": 1, "K1 table free": 1, "K13d place": 1}


def insert_launches(fn, what: str) -> None:
    """fn() makes one table insert: its launches must be INSERT_LAUNCHES."""
    from siddhi_tpu_torch import kernels
    kernels.reset_launch_counts()
    fn()
    got = {k: kernels.LAUNCHES[k] for k in INSERT_LAUNCHES}
    if got != INSERT_LAUNCHES:
        raise Failure(f"{what}: launches an insert {got}, "
                      f"{INSERT_LAUNCHES} expected")


def check_ac(rt, got, names, feed_cols, trade_cols) -> int:
    feed, sector, weight, _ = feed_cols
    sym, price, volume, ts = trade_cols
    (t_sym, t_sector, t_weight, known, k_sector, wprice, groups,
     sec7) = oracle_ac(feed, sector, weight, sym, price)
    tbl = rt.tables["SymbolTable"]
    rows = tbl.all_rows()
    want_rows = list(zip(names[t_sym], t_sector.tolist(),
                         t_weight.tolist()))
    if rows != want_rows:
        raise Failure("app AC: the table's rows differ from the oracle's")
    if tbl.dropped_duplicates != feed.shape[0] - t_sym.shape[0]:
        raise Failure(f"app AC: {tbl.dropped_duplicates} duplicates "
                      f"dropped, {feed.shape[0] - t_sym.shape[0]} expected")
    kt, en = got["KnownTrades"], got["Enriched"]
    idx = np.nonzero(known)[0]
    if len(kt) != idx.size or len(en) != idx.size:
        raise Failure(f"app AC: {len(kt)} known trades and {len(en)} "
                      f"enriched, {idx.size} expected")
    p32 = price.astype(np.float32)
    for j, i in enumerate(idx):
        e, f = kt[j], en[j]
        if (e.timestamp != ts[i] or e.data[0] != names[sym[i]]
                or e.data[1] != float(p32[i]) or e.data[2] != volume[i]):
            raise Failure(f"app AC: known trade {j} is {e}, lane {i}")
        if (f.timestamp != ts[i] or f.data[0] != names[sym[i]]
                or f.data[1] != k_sector[j]
                or not np.isclose(f.data[2], wprice[j], rtol=RTOL, atol=0)):
            raise Failure(f"app AC: enriched event {j} is {f}, expected "
                          f"({names[sym[i]]}, {k_sector[j]}, {wprice[j]})")
    found = [e.data for e in rt.query(AC_QUERIES[0])]
    if len(found) != len(groups):
        raise Failure(f"app AC: {len(found)} sectors found, {len(groups)}")
    for d, (_, sec, n, w) in zip(found, groups):
        if d[0] != sec or d[1] != n or not np.isclose(d[2], w, rtol=RTOL):
            raise Failure(f"app AC: sector row {d}, expected {(sec, n, w)}")
    found = [e.data for e in rt.query(AC_QUERIES[1])]
    if found != list(zip(names[t_sym[sec7]], t_weight[sec7].tolist())):
        raise Failure("app AC: the sector 7 rows differ from the oracle's")
    return len(kt) + len(en)


def run_ac(torch, rng, card: str, rounds: int = ROUNDS,
           batch: int = BATCH, **sizes) -> dict:
    from siddhi_tpu_torch import SiddhiManager, kernels
    names, feed_cols, trade_cols = ac_events(rng, rounds=rounds,
                                             batch=batch, **sizes)
    feed, sector, weight, feed_ts = feed_cols
    sym, price, volume, ts = trade_cols
    fb = sizes.get("feed_batch", AC_FEED_BATCH)
    feed_columns = {"symbol": names[feed], "sector": sector,
                    "weight": weight}
    trade_columns = {"symbol": names[sym], "price": price,
                     "volume": volume}
    rt = SiddhiManager().create_siddhi_app_runtime(
        APP_AC, batch_size=batch, group_capacity=GROUP_CAP)
    got = {"KnownTrades": [], "Enriched": []}
    for o in got:
        rt.add_callback(o, got[o].extend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hf = rt.get_input_handler("SymbolFeed")
    for s in range(0, feed.shape[0], fb):
        hf.send_columns({k: v[s:s + fb] for k, v in feed_columns.items()},
                        timestamps=feed_ts[s:s + fb])
        rt.flush()
    ht = rt.get_input_handler("TradeStream")
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        ht.send_columns({k: v[s] for k, v in trade_columns.items()},
                        timestamps=ts[s])
        rt.flush()
    for q in AC_QUERIES:
        rt.query(q)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_out = check_ac(rt, got, names, feed_cols, trade_cols)
    del got
    for k in ("K13d dedup", "K13d place", "K1 table free", "K7 table index",
              "K13b final per group", "K3b", "K12a"):
        if launches[k] == 0:
            raise Failure(f"app AC: kernel {k} never launched")
    # each step alone: the inserts into a cleared table (one host read
    # each), the `in` filter and the join (none)
    tbl = rt.tables["SymbolTable"]
    tbl.clear()
    fbat = _batches(rt, "SymbolFeed", feed_columns, feed_ts, fb)
    step, reads = {}, {}
    step["insert"], reads["insert"] = timed_steps(
        torch, lambda b: tbl.insert_batch(b[0]), fbat, 1, "app AC insert")
    insert_launches(lambda: tbl.insert_batch(fbat[0][0]), "app AC insert")
    tbat = _batches(rt, "TradeStream", trade_columns, ts, batch)
    known, jr = rt.query_runtimes["known"], rt.query_runtimes["enrich"]

    def known_step(b):
        known.state, _ = known.step(known.state, b[0], b[1])

    def join_step(b):
        jr.state, _, _ = jr._step_left(jr.state, b[0], b[1])

    step["known"], _ = timed_steps(torch, known_step, tbat, 0,
                                   "app AC known")
    step["enrich"], _ = timed_steps(torch, join_step, tbat, 0,
                                    "app AC enrich")
    n_in = feed.shape[0] + ts.shape[0]
    report_app("AC", n_in, n_out, elapsed, sum(step.values()), peak,
               launches, reads["insert"], card, rounds=rounds, batch=batch)
    print(f"app AC: steps alone, ms a batch: {step}; host reads a step: "
          "insert 1 (overflow and dropped, one copy), known 0, enrich 0; "
          f"launches an insert: {INSERT_LAUNCHES}")
    return launches


def ad_events(rng, rounds: int = ROUNDS, batch: int = AD_BATCH,
              n_ids: int = AD_IDS, txn_batches: int = AD_TXN_BATCHES,
              n_close: int = AD_CLOSE):
    n = rounds * txn_batches * batch
    ids = rng.integers(0, n_ids, n).astype(np.int64)
    amount = rng.uniform(-1500.0, 1000.0, n)
    kind = rng.integers(0, AD_KINDS, n).astype(np.int32)
    close = rng.integers(0, n_ids, rounds * n_close).astype(np.int64)
    return ids, amount, kind, close


class AccountOracle:
    """A numpy model of app AD's table under the JAX semantics."""

    def __init__(self, C: int, n_ids: int):
        self.id = np.zeros(C, np.int64)
        self.balance = np.zeros(C, np.float32)
        self.kind = np.zeros(C, np.int32)
        self.ts = np.zeros(C, np.int64)
        self.valid = np.zeros(C, bool)
        self.slot_of = np.full(n_ids, -1)

    def update_or_insert(self, ids, amount32, kind, ts):
        s = self.slot_of[ids]
        hit = np.nonzero(s >= 0)[0]
        # the last matching event of each row, against the old row
        rev = hit[::-1]
        _, first = np.unique(s[rev], return_index=True)
        last = rev[first]
        rows = s[last]
        self.balance[rows] = self.balance[rows] + amount32[last]
        self.kind[rows] = kind[last]
        # unmatched events: the first of each id inserts, into free rows
        miss = np.nonzero(s < 0)[0]
        _, first = np.unique(ids[miss], return_index=True)
        new = miss[np.sort(first)]
        free = np.nonzero(~self.valid)[0][:new.size]
        if free.size < new.size:
            raise Failure("app AD's oracle: the table overflowed")
        self.id[free] = ids[new]
        self.balance[free] = amount32[new]
        self.kind[free] = kind[new]
        self.ts[free] = ts[new]
        self.valid[free] = True
        self.slot_of[ids[new]] = free

    def delete(self, rows):
        rows = rows[self.valid[rows]]
        self.valid[rows] = False
        self.slot_of[self.id[rows]] = -1

    def rows(self):
        v = np.nonzero(self.valid)[0]
        return list(zip(self.id[v].tolist(), self.balance[v].tolist(),
                        self.kind[v].tolist()))

    def by_kind(self):
        """Each kind's (last row, ts of that row, sum, sum of magnitudes,
        count), in the order of the last rows."""
        v = np.nonzero(self.valid)[0]
        out = []
        for k in np.unique(self.kind[v]):
            idx = v[self.kind[v] == k]
            b = self.balance[idx].astype(np.float64)
            out.append((int(idx[-1]), int(self.ts[idx[-1]]), int(k),
                        float(b.sum()), float(np.abs(b).sum()), idx.size))
        out.sort()
        return out


def run_ad(torch, rng, card: str, rounds: int = ROUNDS,
           batch: int = AD_BATCH, C: int = TABLE_C, **sizes) -> dict:
    from siddhi_tpu_torch import SiddhiManager, kernels
    n_ids = sizes.get("n_ids", AD_IDS)
    txn_batches = sizes.get("txn_batches", AD_TXN_BATCHES)
    n_close = sizes.get("n_close", AD_CLOSE)
    ids, amount, kind, close = ad_events(rng, rounds, batch, n_ids,
                                         txn_batches, n_close)
    t0_ms = 1_700_000_000_000
    per_round = txn_batches * batch + n_close
    rt = SiddhiManager().create_siddhi_app_runtime(
        APP_AD, batch_size=batch, group_capacity=GROUP_CAP)
    oracle = AccountOracle(C, n_ids)
    a32 = amount.astype(np.float32)
    found_rounds = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ht, hc = rt.get_input_handler("Txn"), rt.get_input_handler("Close")
    host_s = 0.0
    for r in range(rounds):
        base = t0_ms + r * per_round
        for k in range(txn_batches):
            s = slice((r * txn_batches + k) * batch,
                      (r * txn_batches + k + 1) * batch)
            ts = base + k * batch + np.arange(batch, dtype=np.int64)
            ht.send_columns({"id": ids[s], "amount": amount[s],
                             "kind": kind[s]}, timestamps=ts)
            rt.flush()
            h0 = time.perf_counter()
            oracle.update_or_insert(ids[s], a32[s], kind[s], ts)
            host_s += time.perf_counter() - h0
        cs = slice(r * n_close, (r + 1) * n_close)
        hc.send_columns({"id": close[cs]}, timestamps=np.full(
            n_close, base + txn_batches * batch, np.int64))
        rt.flush()
        found = rt.query(AD_QUERIES[0])
        rt.query(AD_QUERIES[1])
        h0 = time.perf_counter()
        oracle.delete(oracle.slot_of[close[cs]][
            oracle.slot_of[close[cs]] >= 0])
        found_rounds.append(([(e.timestamp, e.data) for e in found],
                             oracle.by_kind()))
        low = np.nonzero(oracle.valid & (oracle.balance
                                         < np.float32(AD_FLOOR)))[0]
        oracle.delete(low)
        host_s += time.perf_counter() - h0
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 - host_s  # the oracle's time out
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = rt.tables["Account"].all_rows()
    if rows != oracle.rows():
        raise Failure("app AD: the table's rows differ from the oracle's")
    n_out = 0
    for r, (found, want) in enumerate(found_rounds):
        if len(found) != len(want):
            raise Failure(f"app AD round {r}: {len(found)} kinds found, "
                          f"{len(want)} expected")
        for (ts, d), (_, wts, k, total, mag, n) in zip(found, want):
            if ts != wts or d[0] != k or d[2] != n or \
                    abs(d[1] - total) > RTOL * mag + 1e-3:
                raise Failure(f"app AD round {r}: found {(ts, d)}, "
                              f"expected {(wts, k, total, n)}")
        n_out += len(found)
    for k in ("K13e eq", "K13e", "K13d dedup", "K13d place",
              "K1 table free", "K13b final per group", "K12a"):
        if launches[k] == 0:
            raise Failure(f"app AD: kernel {k} never launched")
    # each step alone on a cleared table: an update-or-insert batch (one
    # host read, its insert's) and a delete batch (none)
    tbl = rt.tables["Account"]
    tbl.clear()
    txn, cls = rt.query_runtimes["txn"], rt.query_runtimes["close"]
    n_txn = rounds * txn_batches * batch
    tb = _batches(rt, "Txn", {"id": ids, "amount": amount, "kind": kind},
                  t0_ms + np.arange(n_txn, dtype=np.int64), batch)
    cb = _batches(rt, "Close", {"id": close},
                  t0_ms + n_txn + np.arange(close.shape[0], dtype=np.int64),
                  n_close)
    step = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step["update or insert"], reads = timed_steps(
        torch, lambda b: txn.on_batch(*b), tb, 1, "app AD txn")
    uoi_peak = torch.cuda.max_memory_allocated()
    insert_launches(lambda: txn.on_batch(*tb[0]), "app AD txn")
    # the ON condition `Account.id == id` takes K13e's equality route
    if (kernels.LAUNCHES["K13e eq"], kernels.LAUNCHES["K13e"]) != (1, 0):
        raise Failure("app AD txn: K13e launches a step (equality, mask) "
                      f"{kernels.LAUNCHES['K13e eq']}, "
                      f"{kernels.LAUNCHES['K13e']}; 1, 0 expected")
    step["delete"], _ = timed_steps(torch, lambda b: cls.on_batch(*b), cb, 0,
                                    "app AD close")
    q0 = time.perf_counter()
    for q in AD_QUERIES:
        rt.query(q)
    torch.cuda.synchronize()
    step["on-demand pair"] = (time.perf_counter() - q0) * 1e3
    n_in = n_txn + close.shape[0]
    report_app("AD", n_in, n_out, elapsed, step["update or insert"]
               * txn_batches + step["delete"], peak, launches, reads, card,
               rounds=rounds, batch=per_round)
    print(f"app AD: steps alone, ms a batch: {step}; host reads a step: "
          "update or insert 1 (its insert's overflow and dropped, one "
          f"copy), delete 0; {len(rows)} rows at the end; launches an "
          f"insert: {INSERT_LAUNCHES}; K13e a txn step: one equality "
          "launch; peak device memory of the update-or-insert steps "
          f"{uoi_peak / 2**20:.1f} MiB")
    return launches


def table_apps(torch, rng, card: str, rounds: int = ROUNDS,
               batch: int = BATCH, ad_batch: int = AD_BATCH,
               ac_sizes=None, ad_sizes=None) -> dict:
    """Apps AC and AD; returns their launches."""
    total = {}
    for launches in (run_ac(torch, rng, card, rounds, batch,
                            **(ac_sizes or {})),
                     run_ad(torch, rng, card, rounds, ad_batch,
                            **(ad_sizes or {}))):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------- #
# phases 26-27: incremental aggregation (K13f, apps AE and AF)
# --------------------------------------------------------------------------- #

AE_SYMBOLS = 10_000
AE_T0 = 1_767_225_000_000  # 2025-12-31 23:50:00 UTC
AE_RETENTION = 300_000  # @retentionPeriod(sec='5 min')
AE_QUERIES = 4_096  # QueryStream events a round
AE_NAN = 16  # NaN prices a round
AE_HOT = 10_000  # distinct slots of the high-contention shape
AF_ROUNDS = 4  # rounds before AF's restart
AF_ROWS = 90_000  # AF's `min` rows at the restart
FAR_FUTURE = 4_102_444_800_000  # 2100-01-01
#: AE's components in store order: total, avg's sum and count, lo, hi, n,
#: vol
AE_OPS = ("add", "add", "add", "min", "max", "add", "add")

APP_AE = """@app:playback
define stream TradeStream (symbol string, price double, volume long, ts long);
define stream QueryStream (symbol string);
@purge(enable='true', @retentionPeriod(sec='5 min'))
define aggregation TradeAgg from TradeStream
select symbol, sum(price) as total, avg(price) as avgPrice,
       min(price) as lo, max(price) as hi, count() as n, sum(volume) as vol
group by symbol
aggregate by ts every sec ... year;
@info(name = 'rollup')
from QueryStream join TradeAgg on QueryStream.symbol == TradeAgg.symbol
per 'hour'
select QueryStream.symbol as symbol, TradeAgg.AGG_TIMESTAMP as bucket,
       TradeAgg.total as total, TradeAgg.n as n
insert into HourRollup;
"""
AE_FINDS = {
    "min": "from TradeAgg within {lo}, {hi} per 'min' select symbol, total, "
           "avgPrice, lo, hi, n, vol, AGG_TIMESTAMP",
    "months": "from TradeAgg within '2025-12-01 00:00:00', "
              "'2026-02-01 00:00:00' per 'month' select symbol, total, "
              "avgPrice, lo, hi, n, vol, AGG_TIMESTAMP",
    "years": "from TradeAgg within '2025-01-01 00:00:00', "
             "'2027-01-01 00:00:00' per 'year' select symbol, total, "
             "avgPrice, lo, hi, n, vol, AGG_TIMESTAMP",
}
AE_SEC_FIND = ("from TradeAgg within {lo}, {hi} per 'sec' select symbol, "
               "sum(total) as total, sum(n) as n, sum(vol) as vol "
               "group by symbol")

APP_AF = """@app:playback
define stream TradeStream (symbol string, price double, volume long, ts long);
@store(type='durable')
define aggregation TradeAggD from TradeStream
select symbol, sum(price) as total, count() as n
group by symbol
aggregate by ts every min, hour, day;
"""


def _ae_store(torch, dev, K: int, n_comps: int = 7) -> dict:
    """A store of app AE's layout (bucket, symbol, alive and the seven
    components at their initial values); AF's when n_comps is 2."""
    f32, i64 = torch.float32, torch.int64
    comps = ([torch.zeros(K, dtype=f32, device=dev) for _ in range(3)]
             + [torch.full((K,), float("inf"), dtype=f32, device=dev),
                torch.full((K,), float("-inf"), dtype=f32, device=dev)]
             + [torch.zeros(K, dtype=i64, device=dev) for _ in range(2)])
    if n_comps == 2:
        comps = [comps[0], comps[5]]
    return {"bucket": torch.zeros(K, dtype=i64, device=dev),
            "symbol": torch.zeros(K, dtype=torch.int32, device=dev),
            "alive": torch.zeros(K, dtype=torch.bool, device=dev),
            "comps": comps}


def _store_cols(store: dict, src: dict, ops) -> list:
    return ([(store["bucket"], src["bucket"], "set"),
             (store["symbol"], src["symbol"], "set"),
             (store["alive"], None, "true")]
            + [(d, s, op) for d, s, op in zip(store["comps"], src["comps"],
                                               ops)])


def _store_clone(store: dict) -> dict:
    return {k: ([c.clone() for c in v] if k == "comps" else v.clone())
            for k, v in store.items()}


def _check_float_sum(name, got, want, mag) -> float:
    """A float32 scatter sum against its plain version: NaN and inf where
    the plain version has them, the rest within 1e-5 of the slot's sum of
    magnitudes (atomics add in another order)."""
    import torch
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want))
            and torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])):
        raise Failure(f"{name}: NaN or inf slots differ from the plain "
                      "version's")
    fin = torch.isfinite(want)
    err = (got[fin].double() - want[fin].double()).abs()
    tol = RTOL * torch.clamp(mag[fin], min=1.0)
    if bool((err > tol).any()):
        raise Failure(f"{name}: off by {float(err.max())} beyond 1e-5 of "
                      "the slot's sum of magnitudes")
    return float(err.max()) if err.numel() else 0.0


def _ae_lanes(torch, rng, dev, B: int, K: int, hot: int = 0) -> dict:
    """B lanes of app AE's ingest: their slots (2% dropped at K; `hot`
    distinct slots when given), bucket and symbol as functions of the slot,
    prices with NaN and ±inf, counts, volumes."""
    if hot:
        pool = rng.choice(K, hot, replace=False)
        slot = pool[rng.integers(0, hot, B)]
    else:
        slot = rng.integers(0, K, B)
    slot = np.where(rng.random(B) < 0.02, K, slot).astype(np.int32)
    price = (rng.integers(1, 400_000, B) * 0.01).astype(np.float32)
    special = rng.random(B)
    price[special < 1e-3] = np.nan
    price[(special >= 1e-3) & (special < 2e-3)] = np.inf
    price[(special >= 2e-3) & (special < 3e-3)] = -np.inf

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    p = t(price)
    one = torch.ones(B, dtype=torch.float32, device=dev)
    n = torch.ones(B, dtype=torch.int64, device=dev)
    vol = t(rng.integers(1, 1000, B).astype(np.int64))
    return {"widx": t(slot),
            "bucket": t(AE_T0 + (slot.astype(np.int64) % 131) * 1000),
            "symbol": t((slot % AE_SYMBOLS).astype(np.int32)),
            "comps": [p, p, one, p, p, n, vol]}


def _check_store(name, got: dict, want: dict, mags: dict) -> float:
    err = 0.0
    for k in ("bucket", "symbol", "alive"):
        check_equal(f"{name} {k}", got[k], want[k])
    for i, (a, b) in enumerate(zip(got["comps"], want["comps"])):
        if i in mags:
            err = max(err, _check_float_sum(f"{name} comp {i}", a, b,
                                            mags[i]))
        else:
            check_equal(f"{name} comp {i}", a, b)
    return err


def aggregation_kernel_phase(torch, rng, B: int = BATCH,
                             K: int = GROUP_CAP, hot: int = AE_HOT,
                             n_restore: int = AF_ROWS) -> dict:
    """K13f (ingest at low and high contention, evict, restore) and the
    aggregation sites of K3 and K4 against their plain versions on the
    card at apps AE's and AF's shapes; K13f timed by device_ms."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import bucket_scatter as bs
    from siddhi_tpu_torch.ops import groupby

    dev = torch.device("cuda")
    res = {}
    # (a) the ingest: AE's ten columns in one launch
    for key, h in (("K13f ingest", 0), ("K13f ingest (10,000 slots)", hot)):
        lanes = _ae_lanes(torch, rng, dev, B, K, h)
        w = lanes["widx"]
        base = _ae_store(torch, dev, K)
        got, want = _store_clone(base), _store_clone(base)
        bs.bucket_scatter(w, _store_cols(got, lanes, AE_OPS))
        bs.bucket_scatter_plain(w, _store_cols(want, lanes, AE_OPS))
        keep = w < K
        idx = w[keep].long()
        mag = torch.zeros(K, dtype=torch.float64, device=dev)
        mag.index_add_(0, idx, lanes["comps"][0][keep].double().abs())
        count = torch.bincount(idx, minlength=K).double()
        err = _check_store(key, got, want, {0: mag, 1: mag, 2: count})
        work = _store_clone(base)
        kept = {k: (v[keep] if k != "comps" else [c[keep] for c in v])
                for k, v in lanes.items()}
        true = torch.ones((), dtype=torch.bool, device=dev)

        def library():
            work["bucket"].index_put_((idx,), kept["bucket"])
            work["symbol"].index_put_((idx,), kept["symbol"])
            work["alive"].index_put_((idx,), true)
            for d, s, op in zip(work["comps"], kept["comps"], AE_OPS):
                if op == "add":
                    d.index_add_(0, idx, s)
                else:
                    d.scatter_reduce_(0, idx, s, reduce="a" + op,
                                      include_self=True)

        touched = int(torch.unique(idx).numel())
        res[key] = dict(
            _timed_device(torch,
                          lambda: bs.bucket_scatter(
                              w, _store_cols(work, lanes, AE_OPS)),
                          lambda: bs.bucket_scatter_plain(
                              w, _store_cols(work, lanes, AE_OPS)),
                          library=library),
            bound_ms=bound_ms(scatter_bytes(
                w, _store_cols(work, lanes, AE_OPS))),
            max_abs_err=err, bound_by="bytes")
        print(f"{key} B={B} into K={K}, {touched} slots touched, "
              f"{int(keep.sum())} lanes kept: {res[key]}")

    # (b) the evict: a K-slot store, 40% alive, 70% of those kept, into a
    # fresh store at dense ids in K4's order (a permutation)
    old = _store_clone(base)
    alive = torch.from_numpy(rng.random(K) < 0.4).to(dev)
    old["alive"].copy_(alive)
    old["bucket"].copy_(torch.from_numpy(
        AE_T0 + rng.integers(0, 431, K) * 1000).to(dev))
    old["symbol"].copy_(torch.from_numpy(
        rng.integers(0, AE_SYMBOLS, K).astype(np.int32)).to(dev))
    for c in old["comps"]:
        c.copy_(torch.from_numpy(rng.integers(-500, 500, K)).to(dev)
                .to(c.dtype))
    keep = alive & torch.from_numpy(rng.random(K) < 0.7).to(dev)
    n_keep = int(keep.sum())
    ids = torch.full((K,), K, dtype=torch.int32, device=dev)
    ids[keep] = torch.from_numpy(rng.permutation(n_keep).astype(
        np.int32)).to(dev)
    src = {"bucket": old["bucket"], "symbol": old["symbol"],
           "comps": old["comps"]}
    set_ops = ("set",) * 7
    got, want = _ae_store(torch, dev, K), _ae_store(torch, dev, K)
    bs.bucket_scatter(ids, _store_cols(got, src, set_ops),
                      counter="K13f evict")
    bs.bucket_scatter_plain(ids, _store_cols(want, src, set_ops))
    _check_store("K13f evict", got, want, {})
    kidx = ids[keep].long()
    ksrc = [c[keep] for c in [old["bucket"], old["symbol"]] + old["comps"]]
    true = torch.ones((), dtype=torch.bool, device=dev)

    def library_evict():
        for d, s in zip([got["bucket"], got["symbol"]] + got["comps"], ksrc):
            d.index_put_((kidx,), s)
        got["alive"].index_put_((kidx,), true)

    res["K13f evict"] = dict(
        _timed_device(torch,
                      lambda: bs.bucket_scatter(
                          ids, _store_cols(got, src, set_ops),
                          counter="K13f evict"),
                      lambda: bs.bucket_scatter_plain(
                          ids, _store_cols(want, src, set_ops)),
                      library=library_evict),
        bound_ms=bound_ms(scatter_bytes(ids, _store_cols(got, src,
                                                         set_ops))),
        max_abs_err=0, bound_by="bytes")
    print(f"K13f evict K={K}, {n_keep} kept: {res['K13f evict']}")

    # (c) the restore: AF's `min` rows into a fresh store of AF's layout
    n = n_restore
    rids = torch.from_numpy(rng.permutation(K)[:n].astype(np.int32)).to(dev)
    rsrc = {"bucket": torch.from_numpy(AE_T0 + rng.integers(0, 9, n)
                                       * 60_000).to(dev),
            "symbol": torch.from_numpy(rng.integers(0, AE_SYMBOLS, n)
                                       .astype(np.int32)).to(dev),
            "comps": [torch.from_numpy(rng.random(n).astype(np.float32)
                                       * 1e5).to(dev),
                      torch.from_numpy(rng.integers(1, 40, n)).to(dev)]}
    got, want = _ae_store(torch, dev, K, 2), _ae_store(torch, dev, K, 2)
    bs.bucket_scatter(rids, _store_cols(got, rsrc, ("set", "set")),
                      counter="K13f restore")
    bs.bucket_scatter_plain(rids, _store_cols(want, rsrc, ("set", "set")))
    _check_store("K13f restore", got, want, {})
    ridx = rids.long()

    def library_restore():
        for d, s in zip([got["bucket"], got["symbol"]] + got["comps"],
                        [rsrc["bucket"], rsrc["symbol"]] + rsrc["comps"]):
            d.index_put_((ridx,), s)
        got["alive"].index_put_((ridx,), true)

    res["K13f restore"] = dict(
        _timed_device(torch,
                      lambda: bs.bucket_scatter(
                          rids, _store_cols(got, rsrc, ("set", "set")),
                          counter="K13f restore"),
                      lambda: bs.bucket_scatter_plain(
                          rids, _store_cols(want, rsrc, ("set", "set"))),
                      library=library_restore),
        bound_ms=bound_ms(scatter_bytes(
            rids, _store_cols(got, rsrc, ("set", "set")))),
        max_abs_err=0, bound_by="bytes")
    print(f"K13f restore {n} rows into K={K}: {res['K13f restore']}")

    # (d) K3 on (bucket, symbol) and K4 into a sec store at its steady
    # state: ~125,000 new keys a batch onto 2^18 present
    lanes = _ae_lanes(torch, rng, dev, B, K)
    parts = [lanes["bucket"], lanes["symbol"]]
    check_equal("K3 aggregation",
                groupby.hash_columns(parts, counter="K3 aggregation"),
                groupby.hash_columns_plain(parts))
    res["K3 aggregation"] = dict(
        _timed(torch, lambda: groupby.hash_columns(
                   parts, counter="K3 aggregation"),
               lambda: groupby.hash_columns_plain(parts)),
        bound_ms=bound_ms(B * (8 + 4 + 8)), max_abs_err=0,
        bound_by="bytes")
    print(f"K3 aggregation n={B} (int64 bucket, int32 symbol): "
          f"{res['K3 aggregation']}")
    table = groupby.init_key_table(K, dev)
    pre = torch.from_numpy(rng.integers(0, 2**62, K // 4,
                                        dtype=np.int64)).to(dev)
    table, _, _ = groupby.key_lookup_or_insert(
        table, pre, torch.ones(pre.shape[0], dtype=torch.bool, device=dev),
        counter="K4 aggregation")
    n_fresh = B * 125 // 131  # distinct (second, symbol) keys a batch
    fresh = rng.integers(2**62, 2**63 - 1, n_fresh, dtype=np.int64)
    keys = torch.from_numpy(rng.permutation(np.concatenate(
        [fresh, fresh[rng.integers(0, n_fresh, B - n_fresh)]]))).to(dev)
    valid = torch.from_numpy(rng.random(B) < 0.98).to(dev)
    saved = [t.clone() for t in table]
    count0 = int(table.count)

    def restore4():
        for t_, s_ in zip(table, saved):
            t_.copy_(s_)

    p_tab, p_ids, p_res = groupby.key_lookup_or_insert_plain(
        groupby.KeyTable(*[t_.clone() for t_ in saved]), keys, valid)
    restore4()
    k_tab, k_ids, k_res = groupby.key_lookup_or_insert(
        table, keys, valid, counter="K4 aggregation")
    for nm, a, b in (("keys", k_tab.keys, p_tab.keys),
                     ("ids", k_tab.ids, p_tab.ids),
                     ("count", k_tab.count, p_tab.count),
                     ("misses", k_tab.misses, p_tab.misses),
                     ("lane ids", k_ids, p_ids),
                     ("resolved", k_res, p_res)):
        check_equal(f"K4 aggregation {nm}", a, b)
    n_new = int(k_tab.count) - count0
    n_valid = int(valid.sum())
    res["K4 aggregation"] = dict(
        _timed(torch, lambda: groupby.key_lookup_or_insert(
                   table, keys, valid, counter="K4 aggregation"),
               lambda: groupby.key_lookup_or_insert_plain(table, keys, valid),
               reset=restore4),
        bound_ms=bound_ms(B * (8 + 1 + 4 + 1) + n_valid * 12 + n_new * 12),
        max_abs_err=0, bound_by="bytes")
    restore4()
    kernels.reset_launch_counts()
    groupby.key_lookup_or_insert(table, keys, valid,
                                 counter="K4 aggregation")
    print(f"K4 aggregation H={2 * K} prefilled={count0} new={n_new}: "
          f"{res['K4 aggregation']}; "
          f"{kernels.LAUNCHES['K4 aggregation']} launch a call")
    keytable_steady_state(torch, groupby, kernels, table, restore4, valid,
                          "K4 aggregation")
    torch.cuda.synchronize()
    return res


def ae_events(rng, rounds: int = ROUNDS, batch: int = BATCH,
              n_symbols: int = AE_SYMBOLS, n_queries: int = AE_QUERIES,
              spacing: int = 1):
    """The trades (1 ms apart from 2025-12-31 23:50:00 UTC, crossing a
    minute, hour, day, month and year; AE_NAN NaN prices a round) and the
    query symbols of each round."""
    n = rounds * batch
    sym = rng.integers(0, n_symbols, n)
    price = rng.integers(1, 400_000, n) * 0.01
    for r in range(rounds):
        price[r * batch + rng.choice(batch, AE_NAN, replace=False)] = np.nan
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = AE_T0 + np.arange(n, dtype=np.int64) * spacing
    names = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    qsym = rng.integers(0, n_symbols, rounds * n_queries)
    return names, (sym, price, volume, ts), qsym


def _bucket_np(ts: np.ndarray, dur: str) -> np.ndarray:
    """Bucket starts by numpy alone: fixed widths by ts - ts % w, months
    and years through datetime64."""
    w = {"sec": 1_000, "min": 60_000, "hours": 3_600_000,
         "days": 86_400_000}.get(dur)
    if w is not None:
        return ts - ts % w
    unit = "M" if dur == "months" else "Y"
    return (ts.astype("datetime64[ms]").astype(f"datetime64[{unit}]")
            .astype("datetime64[ms]").astype(np.int64))


def oracle_buckets(trades, dur: str, n_symbols: int, lo=None, hi=None):
    """Per (bucket, symbol) of the trades whose bucket lies in [lo, hi):
    sums in float64 of the float32 prices and of their magnitudes, counts,
    int64 volume sums, float32 min and max (NaN wins)."""
    sym, price, volume, ts = trades
    b = _bucket_np(ts, dur)
    sel = np.ones(b.shape[0], bool)
    if lo is not None:
        sel = (b >= lo) & (b < hi)
    b, s = b[sel], sym[sel]
    p32 = price[sel].astype(np.float32)
    b0 = int(b.min()) if b.size else 0
    uk, inv = np.unique((b - b0) * n_symbols + s, return_inverse=True)
    m = uk.shape[0]
    total, mag = np.zeros(m), np.zeros(m)
    np.add.at(total, inv, p32.astype(np.float64))
    np.add.at(mag, inv, np.abs(p32.astype(np.float64)))
    vol = np.zeros(m, np.int64)
    np.add.at(vol, inv, volume[sel])
    lo_, hi_ = np.full(m, np.inf, np.float32), np.full(m, -np.inf,
                                                        np.float32)
    with np.errstate(invalid="ignore"):  # NaN prices win, as on the card
        np.minimum.at(lo_, inv, p32)
        np.maximum.at(hi_, inv, p32)
    return {"bucket": uk // n_symbols + b0, "sym": uk % n_symbols,
            "total": total, "mag": mag, "n": np.bincount(inv, minlength=m),
            "vol": vol, "lo": lo_, "hi": hi_}


def _close(name, got, want, mag) -> None:
    """A float32 sum: NaN where the oracle has NaN, else within 1e-5 of
    the sum of magnitudes."""
    if np.isnan(want) or np.isnan(got):
        if not (np.isnan(want) and np.isnan(got)):
            raise Failure(f"{name}: {got}, the oracle says {want}")
        return
    if abs(got - want) > RTOL * max(mag, 1.0):
        raise Failure(f"{name}: {got}, the oracle says {want} (sum of "
                      f"magnitudes {mag})")


def _same_float(name, got, want) -> None:
    if not (got == want or (np.isnan(got) and np.isnan(want))):
        raise Failure(f"{name}: {got}, the oracle says {want}")


def check_ae_buckets(what: str, got: list, orc: dict, names) -> int:
    """Rows (symbol, total, avgPrice, lo, hi, n, vol, AGG_TIMESTAMP)
    against oracle_buckets: counts, volumes, min, max and buckets exact,
    sums within 1e-5 of the sum of magnitudes."""
    if len(got) != orc["n"].shape[0]:
        raise Failure(f"{what}: {len(got)} rows, the oracle has "
                      f"{orc['n'].shape[0]}")
    index = {(names[s], int(b)): i for i, (s, b) in
             enumerate(zip(orc["sym"].tolist(), orc["bucket"].tolist()))}
    for row in got:
        sym, total, avg, lo, hi, n, vol, b = row
        i = index.get((sym, b))
        if i is None:
            raise Failure(f"{what}: row {row} is not in the oracle")
        if n != orc["n"][i] or vol != orc["vol"][i]:
            raise Failure(f"{what}: row {row}: n {orc['n'][i]}, vol "
                          f"{orc['vol'][i]} expected")
        _close(f"{what} {sym}@{b} total", total, orc["total"][i],
               orc["mag"][i])
        _close(f"{what} {sym}@{b} avg", avg, orc["total"][i] / n,
               orc["mag"][i] / n)
        _same_float(f"{what} {sym}@{b} lo", lo, float(orc["lo"][i]))
        _same_float(f"{what} {sym}@{b} hi", hi, float(orc["hi"][i]))
    return len(got)


def check_ae_sec_find(got: list, trades, names, lo: int, hi: int,
                      n_symbols: int) -> int:
    """The grouped find over the `sec` buckets in [lo, hi): per symbol
    sums of totals (1e-5 of the magnitudes), counts and volumes."""
    orc = oracle_buckets(trades, "sec", n_symbols, lo, hi)
    total, mag = np.zeros(n_symbols), np.zeros(n_symbols)
    np.add.at(total, orc["sym"], orc["total"])
    np.add.at(mag, orc["sym"], orc["mag"])
    n = np.bincount(orc["sym"], weights=orc["n"], minlength=n_symbols)
    vol = np.zeros(n_symbols, np.int64)
    np.add.at(vol, orc["sym"], orc["vol"])
    present = np.unique(orc["sym"])
    if len(got) != present.shape[0]:
        raise Failure(f"app AE sec find: {len(got)} symbols, the oracle "
                      f"has {present.shape[0]}")
    code = {nm: i for i, nm in enumerate(names.tolist())}
    for sym, t, c, v in got:
        i = code[sym]
        if c != int(n[i]) or v != int(vol[i]):
            raise Failure(f"app AE sec find: {sym} n {c} vol {v}, the "
                          f"oracle says {int(n[i])}, {int(vol[i])}")
        _close(f"app AE sec find {sym}", t, total[i], mag[i])
    return len(got)


def check_ae_rollup(got: list, trades, names, qsym, n_symbols: int) -> int:
    """The join per 'hour': for each query symbol every hour bucket it has
    so far, with its total and count."""
    from collections import Counter
    orc = oracle_buckets(trades, "hours", n_symbols)
    by_sym: dict = {}
    for i, s in enumerate(orc["sym"].tolist()):
        by_sym.setdefault(s, []).append(i)
    want = Counter()
    for q in qsym.tolist():
        for i in by_sym.get(q, ()):
            want[(names[q], int(orc["bucket"][i]), int(orc["n"][i]))] += 1
    have = Counter((r[0], r[1], r[3]) for r in got)
    if have != want:
        raise Failure(f"app AE rollup: {sum(have.values())} rows, the "
                      f"oracle has {sum(want.values())} "
                      f"({len(have - want)} keys unexpected)")
    index = {(names[s], int(b)): i for i, (s, b) in
             enumerate(zip(orc["sym"].tolist(), orc["bucket"].tolist()))}
    for sym, b, total, _ in got:
        i = index[(sym, b)]
        _close(f"app AE rollup {sym}@{b}", total, orc["total"][i],
               orc["mag"][i])
    return len(got)


def run_ae(torch, rng, card: str, rounds: int = ROUNDS, batch: int = BATCH,
           n_symbols: int = AE_SYMBOLS, n_queries: int = AE_QUERIES,
           spacing: int = 1, gcap: int = GROUP_CAP):
    """App AE against its numpy oracles; returns (launches, the events
    and names for app AF)."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    names, trades, qsym = ae_events(rng, rounds, batch, n_symbols,
                                    n_queries, spacing)
    sym, price, volume, ts = trades
    columns = {"symbol": names[sym], "price": price, "volume": volume,
               "ts": ts}
    rt = SiddhiManager().create_siddhi_app_runtime(
        APP_AE, batch_size=batch, group_capacity=gcap)
    agg = rt.aggregations["TradeAgg"]
    rollups = []
    rt.add_callback("HourRollup", lambda evs: rollups[-1].extend(
        tuple(e.data) for e in evs))
    ht = rt.get_input_handler("TradeStream")
    hq = rt.get_input_handler("QueryStream")
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    busy = 0.0
    with counting_calls(K4_SITES[2:]) as k4:
        for r in range(rounds):
            t0 = time.perf_counter()
            s = slice(r * batch, (r + 1) * batch)
            ht.send_columns({k: v[s] for k, v in columns.items()},
                            timestamps=ts[s])
            rt.flush()
            now = int(ts[s][-1])
            rt.heartbeat(now)
            finds = {"sec": [tuple(e.data) for e in rt.query(
                AE_SEC_FIND.format(lo=now - AE_RETENTION, hi=now + 1))]}
            m0 = now - now % 60_000
            for d, q in AE_FINDS.items():
                finds[d] = [tuple(e.data) for e in rt.query(
                    q.format(lo=m0 - 60_000, hi=m0 + 60_000))]
            rollups.append([])
            qs = qsym[r * n_queries:(r + 1) * n_queries]
            hq.send_columns({"symbol": names[qs]},
                            timestamps=np.full(n_queries, now, np.int64))
            rt.flush()
            torch.cuda.synchronize()
            busy += time.perf_counter() - t0
            # the sec store after retention: only buckets at or after the
            # cutoff (one host read, outside the timed span)
            st = agg.state[0]
            live_b = st.bucket_ts[st.alive].cpu().numpy()
            seen.append((now, finds, int(live_b.size),
                         int(live_b.min()) if live_b.size else None))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_one_launch_a_call("AE", launches, "K4 aggregation", k4["calls"])
    for k in ("K3 aggregation", "K4 aggregation", "K13f ingest",
              "K13f evict", "K13b final per group", "K12a"):
        if launches[k] == 0:
            raise Failure(f"app AE: kernel {k} never launched")
    jr = rt.query_runtimes["rollup"]
    dropped = int(jr._dropped_dev) if jr._dropped_dev is not None else 0
    if dropped:
        raise Failure(f"app AE: {dropped} join pairs dropped")
    bad = {k: v for k, v in rt.ctx.statistics.overflow.items()
           if k.startswith("aggregation:")}
    if bad:
        raise Failure(f"app AE: unplaced buckets {bad}")
    n_rows = 0
    for r, (now, finds, n_live, min_b) in enumerate(seen):
        upto = tuple(a[:(r + 1) * batch] for a in trades)
        cutoff = now - AE_RETENTION
        kept = oracle_buckets(upto, "sec", n_symbols, cutoff, 1 << 62)
        if n_live != kept["n"].shape[0] or (min_b is not None
                                            and min_b < cutoff):
            raise Failure(f"app AE round {r}: the sec store holds {n_live} "
                          f"buckets from {min_b}, the oracle "
                          f"{kept['n'].shape[0]} from {cutoff}")
        n_rows += check_ae_sec_find(finds["sec"], upto, names, cutoff,
                                    now + 1, n_symbols)
        m0 = now - now % 60_000
        n_rows += check_ae_buckets(
            f"app AE round {r} min", finds["min"],
            oracle_buckets(upto, "min", n_symbols, m0 - 60_000,
                           m0 + 60_000), names)
        for d in ("months", "years"):
            n_rows += check_ae_buckets(f"app AE round {r} {d}", finds[d],
                                       oracle_buckets(upto, d, n_symbols),
                                       names)
        n_rows += check_ae_rollup(
            rollups[r], upto, names,
            qsym[r * n_queries:(r + 1) * n_queries], n_symbols)
    years = {row[-1] for row in seen[-1][1]["years"]}
    if spacing == 1 and rounds * batch > 600_000 and len(years) != 2:
        raise Failure(f"app AE: the run crossed no year ({years})")
    # the ingest step alone, from fresh stores, on the same batches; the
    # retention evict between steps is outside the timed span
    items = _batches(rt, "TradeStream", columns, ts, batch)
    agg.state = tuple(agg._init_store() for _ in agg.durations)

    def step(it):
        agg.state = agg._ingest(agg.state, it[0], it[1])

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, syncs = call_watching_syncs(torch, lambda: step(items[0]))
    per_step = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if syncs:
        raise Failure(f"app AE: {len(syncs)} host syncs in an ingest step: "
                      f"{syncs}")
    if per_step.get("K4 aggregation") != len(agg.durations):
        raise Failure(f"app AE: {per_step.get('K4 aggregation')} K4 "
                      f"launches in an ingest step of {len(agg.durations)} "
                      "durations, one a duration expected")
    agg.state = tuple(agg._init_store() for _ in agg.durations)
    step_s = 0.0
    for it in items:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(it)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        agg._maybe_evict(it[1])
    n_in = ts.shape[0] + qsym.shape[0]
    report_app("AE", n_in, n_rows, busy, step_s / rounds * 1e3, peak,
               launches, syncs, card, rounds=rounds, batch=batch)
    print(f"app AE: ingest step launches {per_step}; {n_rows} found and "
          f"joined rows checked; years seen {sorted(years)}")
    # the card's busy time in each part of a round: the last round's work
    # once more under torch.profiler (unchecked; its trades land in the
    # same slots), against the unprofiled round's wall time
    s = slice((rounds - 1) * batch, rounds * batch)
    now = int(ts[s][-1])
    m0 = now - now % 60_000
    qs = qsym[(rounds - 1) * n_queries:rounds * n_queries]
    rollups.append([])

    def ingest():
        ht.send_columns({k: v[s] for k, v in columns.items()},
                        timestamps=ts[s])
        rt.flush()

    def finds():
        rt.query(AE_SEC_FIND.format(lo=now - AE_RETENTION, hi=now + 1))
        for q in AE_FINDS.values():
            rt.query(q.format(lo=m0 - 60_000, hi=m0 + 60_000))

    def join():
        hq.send_columns({"symbol": names[qs]},
                        timestamps=np.full(n_queries, now, np.int64))
        rt.flush()

    parts = {"ingest": ingest, "heartbeat": lambda: rt.heartbeat(now),
             "finds": finds, "join": join}
    dev_ms = {k: device_busy_ms(torch, f) for k, f in parts.items()}
    round_ms = busy / rounds * 1e3
    if all(v is not None for v in dev_ms.values()):
        idle = f"{1 - sum(dev_ms.values()) / round_ms:.4f}"
    else:
        idle = "not measured (no device span in the trace)"
    print(f"app AE: device busy ms in a round by torch.profiler {dev_ms}, "
          f"{sum(v or 0 for v in dev_ms.values())} of a {round_ms:.3f} ms "
          f"round; device idle share {idle} [{card}]")
    return launches, (names, trades)


class AfStore:
    """App AF's durable store: class-level rows, so a new runtime sees
    what the last one wrote (the role an RDBMS plays for the reference)."""

    tables: dict = {}

    @classmethod
    def make(cls):
        from siddhi_tpu_torch.io.record_table import InMemoryRecordStore

        class DurableStore(InMemoryRecordStore):
            def init(self, definition, properties, config_reader=None):
                super().init(definition, properties, config_reader)
                self.rows = list(cls.tables.get(definition.id, []))

            def _sync(self):
                cls.tables[self.definition.id] = list(self.rows)

            def add(self, rows):
                super().add(rows)
                self._sync()

            def delete(self, compiled):
                n = super().delete(compiled)
                self._sync()
                return n

        return DurableStore


def run_af(torch, card: str, names, trades, rounds: int = ROUNDS,
           batch: int = BATCH, restart_after: int = AF_ROUNDS,
           gcap: int = GROUP_CAP) -> dict:
    """App AF: a durable aggregation fed AE's first rounds, shut down
    (the flush), rebuilt in a fresh runtime (the restore), fed the rest,
    every duration against the numpy oracle over all rounds."""
    from siddhi_tpu_torch import SiddhiManager, kernels
    sym, price, volume, ts = trades
    columns = {"symbol": names[sym], "price": price, "volume": volume,
               "ts": ts}
    n_symbols = names.shape[0]
    AfStore.tables.clear()
    store = AfStore.make()

    def runtime():
        mgr = SiddhiManager()
        mgr.set_extension("durable", store)
        return mgr.create_siddhi_app_runtime(APP_AF, batch_size=batch,
                                             group_capacity=gcap)

    def feed(rt, rs):
        h = rt.get_input_handler("TradeStream")
        for r in rs:
            s = slice(r * batch, (r + 1) * batch)
            h.send_columns({k: v[s] for k, v in columns.items()},
                           timestamps=ts[s])
            rt.flush()

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rt = runtime()
    feed(rt, range(restart_after))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.shutdown()
    flush_s = time.perf_counter() - t0
    rows = {k: len(v) for k, v in AfStore.tables.items()}
    del rt
    t0 = time.perf_counter()
    rt2 = runtime()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    feed(rt2, range(restart_after, rounds))
    launches = dict(kernels.LAUNCHES)
    for k in ("K3 aggregation", "K4 aggregation", "K13f ingest",
              "K13f restore"):
        if launches[k] == 0:
            raise Failure(f"app AF: kernel {k} never launched")
    n_rows = 0
    for d, per in (("min", "min"), ("hours", "hour"), ("days", "day")):
        got = [tuple(e.data) for e in rt2.query(
            f"from TradeAggD within 0, {FAR_FUTURE} per '{per}' "
            "select symbol, total, n, AGG_TIMESTAMP")]
        orc = oracle_buckets(trades, d, n_symbols)
        if len(got) != orc["n"].shape[0]:
            raise Failure(f"app AF {d}: {len(got)} rows, the oracle has "
                          f"{orc['n'].shape[0]}")
        index = {(names[s], int(b)): i for i, (s, b) in
                 enumerate(zip(orc["sym"].tolist(),
                               orc["bucket"].tolist()))}
        for s, total, n, b in got:
            i = index.get((s, b))
            if i is None or n != orc["n"][i]:
                raise Failure(f"app AF {d}: row {(s, total, n, b)} not in "
                              "the oracle")
            _close(f"app AF {d} {s}@{b}", total, orc["total"][i],
                   orc["mag"][i])
        n_rows += len(got)
    rt2.shutdown(flush_durable=False)
    print(f"app AF: {ts.shape[0]} events, restart after {restart_after} "
          f"rounds; durable rows at the restart {rows}; flush "
          f"{flush_s * 1e3:.3f} ms, rebuild {rebuild_s * 1e3:.3f} ms; "
          f"{n_rows} rows match the oracle; kernel launches "
          f"{ {k: v for k, v in launches.items() if v} } [{card}]")
    return launches


def aggregation_apps(torch, rng, card: str, rounds: int = ROUNDS,
                     batch: int = BATCH, **sizes) -> dict:
    """Apps AE and AF; returns their launches."""
    total = {}
    launches, (names, trades) = run_ae(torch, rng, card, rounds, batch,
                                       **sizes)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    for k, v in run_af(torch, card, names, trades, rounds, batch,
                       restart_after=min(AF_ROUNDS, rounds // 2),
                       gcap=sizes.get("gcap", GROUP_CAP)).items():
        total[k] = total.get(k, 0) + v
    return total

# --------------------------------------------------------------------------- #
# phases 28-30: K12b, app AG (async ingestion + supersteps), app AH
# --------------------------------------------------------------------------- #

AG_BATCH = BATCH  # @Async(buffer.size='131072')
AG_WORKERS = 4
AG_SYMBOLS = 10_000
AG_GCAP = 1 << 17
AG_CHUNKS = 64  # phase 29 (a): chunks a K
AG_KS = (1, 8, 32)
AG_PRODUCERS = 4
AG_RATE_CHUNKS = 96  # phase 29 (b): chunks a run, whole supersteps at 8, 32
AG_RATE_ROUNDS = 3  # phase 29 (b): runs a K, taken in turn over the Ks
APP_AG = """@app:name('IngressBench{k}')
{ss}@Async(buffer.size='{bs}', workers='{workers}')
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'filt')
from TradeStream[price < 700.0]
select symbol, price, volume
insert into MidStream;
@info(name = 'agg')
from MidStream#window.lengthBatch(10000)
select symbol, sum(price) as total, avg(price) as avgPrice
group by symbol
insert into SummaryStream;
"""
AH_EVENTS = 2_000  # one at a time, at ~1,000 a second
AH_RATE_HZ = 1000.0
APP_AH = """@app:name('AutoFlush')
define stream TradeStream (symbol string, price double, volume long);
@info(name = 'bench')
from TradeStream[700.0 > price]
select symbol, price
insert into OutStream;
"""


def app_ag(k: int, bs: int = AG_BATCH, workers: int = AG_WORKERS) -> str:
    ss = f"@app:superstep(k='{k}')\n" if k > 1 else ""
    return APP_AG.format(k=k, ss=ss, bs=bs, workers=workers)


def ag_slot_width(bs: int = AG_BATCH) -> int:
    """The lanes of app AG's emitting slot: the lengthBatch query's output
    over a full filter output of `bs` lanes."""
    from siddhi_tpu_torch.ops.windows import LengthBatchWindow
    return LengthBatchWindow({}, bs, WINDOW, expired_on=False).chunk_width


def _pack_case(torch, rng, K: int, W: int, dens: float):
    """App AG's slot stacks: int32 symbol codes, float32 total and avg,
    int64 ts; iteration 0 with no valid lane, iteration 1 all valid."""
    dev = torch.device("cuda")
    ts = torch.from_numpy(1_700_000_000_000 + np.sort(
        rng.integers(0, 1 << 31, (K, W)), axis=1)).to(dev)
    valid = rng.random((K, W)) < dens
    valid[0] = False
    valid[1] = True
    cols = {"symbol": torch.from_numpy(rng.integers(
                1, AG_SYMBOLS + 1, (K, W)).astype(np.int32)).to(dev),
            "total": torch.from_numpy(rng.uniform(
                1, 5e4, (K, W)).astype(np.float32)).to(dev),
            "avgPrice": torch.from_numpy(rng.uniform(
                1, 700, (K, W)).astype(np.float32)).to(dev)}
    return ts, torch.from_numpy(valid).to(dev), cols


def _sector_bytes(torch, flat_valid, elem: int) -> int:
    """Bytes of the 32-byte sectors of a column of `elem`-byte lanes that
    hold at least one valid lane."""
    per = 32 // elem
    n = flat_valid.numel()
    v = torch.nn.functional.pad(flat_valid, (0, -n % per))
    return int(v.reshape(-1, per).any(1).sum()) * 32


def superstep_kernel_phase(torch, rng, W: int = 0) -> dict:
    """K12b against its plain version on the card, bit for bit (the header,
    the counts and every region's kept entries), at app AG's emitting slot
    for K = 8 and 32; with its times, the library calls
    (`torch.nonzero_static` of the flattened valid at the kept count, an
    `index_select` a column, `valid.sum(1)`) and the byte bound."""
    from siddhi_tpu_torch.ops import superstep_pack as sp
    W = W or ag_slot_width()
    res = {}
    for K in (8, 32):
        ts, valid, cols = _pack_case(torch, rng, K, W, 0.64)
        buf, layout = sp.superstep_pack(ts, valid, cols)
        plain = sp.superstep_pack_plain(ts, valid, cols)
        check_equal(f"K12b K={K}", sp.pack_payload(buf, layout),
                    sp.pack_payload(plain, layout))
        kept = int(valid.sum())
        widths = 8 + sum(c.element_size() for c in cols.values())

        def library():  # nonzero_static at the known count: no host sync
            idx = torch.nonzero_static(valid.reshape(-1),
                                       size=kept).squeeze(1)
            return ([c.reshape(-1).index_select(0, idx)
                     for c in (ts, *cols.values())], valid.sum(1))

        # valid read whole; ts and each column only in the 32-byte sectors
        # that hold a valid lane (the kernel reads no other lane); the kept
        # rows and the K counts written
        flat = valid.reshape(-1)
        need = (K * W + _sector_bytes(torch, flat, 8)
                + sum(_sector_bytes(torch, flat, c.element_size())
                      for c in cols.values())
                + kept * widths + 8 * K + sp.HEADER_BYTES)
        r = dict(_timed(torch, lambda: sp.superstep_pack(ts, valid, cols),
                        lambda: sp.superstep_pack_plain(ts, valid, cols),
                        library),
                 bound_ms=bound_ms(need), max_abs_err=0, bound_by="bytes")
        print(f"K12b superstep_pack K={K} W={W} kept={kept}: {r}")
        res["K12b" if K == 8 else "K12b (K = 32)"] = r
    torch.cuda.synchronize()
    return res


def ag_events(rng, n: int):
    """bench.py's IngressBench data: symbols uniform over 10,000 (the same
    string objects, as a producer's dictionary would hold them), prices
    and volumes uniform in [1, 1000)."""
    pool = np.array([f"S{k}" for k in range(1, AG_SYMBOLS + 1)],
                    dtype=object)
    key = rng.integers(0, AG_SYMBOLS, n)
    price = rng.uniform(1.0, 1000.0, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    return key, pool[key], price, volume


def run_ag(torch, k: int, chunks, bs: int, producers: int = 1,
           record=None):
    """One fresh runtime of app AG at superstep depth k: `producers`
    threads each send their share of `chunks` ((ts, columns) of bs rows)
    by send_columns, then one drain. Returns (blocks, arrival times, send
    times by chunk, elapsed s, stats_snapshot, launches, the string
    table)."""
    from siddhi_tpu_torch import kernels
    rt = make_runtime(app_ag(k, bs), bs, AG_GCAP, async_cb=True)
    blocks, arrivals = [], []

    def on_block(b):
        arrivals.append(time.perf_counter())
        blocks.append((b.timestamps, b.columns))

    rt.add_callback("SummaryStream", on_block, columnar=True)
    rt.start()
    h = rt.get_input_handler("TradeStream")
    sent = np.zeros(len(chunks))
    errors = []

    def producer(p):
        try:
            for c in range(p, len(chunks), producers):
                ts, cols = chunks[c]
                sent[c] = time.perf_counter()
                h.send_columns(cols, timestamps=ts)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if record is not None:
            record(rt)
        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        rt.drain()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        snap = rt.junctions["TradeStream"]._pipeline.stats_snapshot()
        strings = list(rt.ctx.global_strings._to_str)
    finally:
        rt.shutdown()
    return blocks, np.array(arrivals), sent, elapsed, snap, launches, strings


def _ag_chunks(rng, n_chunks: int, bs: int, t_base: int):
    key, sym, price, volume = ag_events(rng, n_chunks * bs)
    ts = t_base + np.arange(n_chunks * bs, dtype=np.int64)
    chunks = [(ts[c * bs:(c + 1) * bs],
               {"symbol": sym[c * bs:(c + 1) * bs],
                "price": price[c * bs:(c + 1) * bs],
                "volume": volume[c * bs:(c + 1) * bs]})
              for c in range(n_chunks)]
    return chunks, key, price, ts


def _concat_blocks(blocks):
    if not blocks:
        return np.zeros(0, np.int64), {}, []
    ts = np.concatenate([b[0] for b in blocks])
    cols = {c: np.concatenate([b[1][c] for b in blocks])
            for c in blocks[0][1]}
    return ts, cols, [len(b[0]) for b in blocks]


def check_ag(name: str, blocks, strings, key, price, ts) -> int:
    """App AG's output against app A's lengthBatch oracle behind the
    filter: every row's timestamp and symbol exact, sums and averages
    within rtol 1e-5 of the float64 oracle."""
    price32 = price.astype(np.float32)
    passed = price32 < np.float32(700.0)
    sel, total, avg, ots = oracle(key, price32, ts, passed)
    g_ts, g_cols, _ = _concat_blocks(blocks)
    if g_ts.shape[0] != sel.shape[0]:
        raise Failure(f"app {name}: {g_ts.shape[0]} rows out, the oracle "
                      f"expects {sel.shape[0]}")
    if not np.array_equal(g_ts, ots):
        raise Failure(f"app {name}: timestamps differ from the oracle")
    lut = np.array([-1] + [int(s[1:]) - 1 for s in strings[1:]],
                   dtype=np.int64)
    if not np.array_equal(lut[g_cols["symbol"]], key[sel]):
        raise Failure(f"app {name}: symbols differ from the oracle")
    for c, want in (("total", total), ("avgPrice", avg)):
        if not np.allclose(g_cols[c], want, rtol=RTOL, atol=0):
            raise Failure(f"app {name}: {c} beyond rtol 1e-5 of the oracle")
    return int(sel.shape[0])


def _same_blocks(name: str, got, want) -> None:
    g_ts, g_cols, g_n = _concat_blocks(got)
    w_ts, w_cols, w_n = _concat_blocks(want)
    if g_n != w_n or not np.array_equal(g_ts, w_ts):
        raise Failure(f"{name}: blocks differ from K = 1")
    for c in w_cols:
        if g_cols[c].dtype != w_cols[c].dtype or not np.array_equal(
                g_cols[c].view(np.uint8), w_cols[c].view(np.uint8)):
            raise Failure(f"{name}: column {c} differs from K = 1")


def ag_app(torch, rng, card: str, bs: int = AG_BATCH,
           n_chunks: int = AG_CHUNKS, ks=AG_KS, producers: int = AG_PRODUCERS,
           rate_chunks=None) -> tuple[dict, dict]:
    """Phase 29: app AG, bench.py's IngressBench. (a) one producer, 64
    chunks at each K on fresh runtimes: K = 1 against the oracle, each K >
    1 bit-identical to K = 1 with 64 / K supersteps, no decline and one
    K12b launch a superstep and emitting slot; (b) four producers, the
    same 96 chunks a run with one drain, AG_RATE_ROUNDS runs a K taken in
    turn over the Ks: events/s (median and every run), send-to-callback
    latency, the pipeline's stage times, conservation, and the host syncs
    of one superstep. Returns (launches of (a)'s runs, the rate lines)."""
    chunks, key, price, ts = _ag_chunks(rng, n_chunks, bs, 1_700_000_000_000)
    launches = {k: 0 for k in KERNELS}
    ref = None
    for k in ks:
        blocks, _, _, elapsed, snap, la, strings = run_ag(torch, k, chunks,
                                                          bs)
        for name, v in la.items():
            if name in launches:
                launches[name] += v
        if k == 1:
            n_out = check_ag("AG (K = 1)", blocks, strings, key, price, ts)
            ref = (blocks, strings)
        else:
            if strings != ref[1]:
                raise Failure(f"app AG K={k}: string codes differ")
            _same_blocks(f"app AG K={k}", blocks, ref[0])
            if snap["superstep_decline"] is not None:
                raise Failure(f"app AG K={k} declined: "
                              f"{snap['superstep_decline']}")
            if snap["supersteps_dispatched"] != n_chunks // k:
                raise Failure(f"app AG K={k}: {snap['supersteps_dispatched']}"
                              f" supersteps, expected {n_chunks // k}")
            if la["K12b"] != snap["supersteps_dispatched"]:
                raise Failure(f"app AG K={k}: {la['K12b']} K12b launches "
                              f"for {snap['supersteps_dispatched']} "
                              "supersteps of one emitting slot")
        print(f"app AG K={k} exactness: {n_chunks * bs} events in, "
              f"{sum(len(b[0]) for b in blocks)} out, "
              + ("matches the oracle" if k == 1 else "bit-identical to K = 1")
              + f"; supersteps {snap['supersteps_dispatched']}, decline "
              f"{snap['superstep_decline']}, {n_chunks * bs / elapsed:.1f} "
              f"events/s; launches "
              f"{ {n: v for n, v in la.items() if v} } [{card}]")
    n = rate_chunks or AG_RATE_CHUNKS
    rchunks, rkey, rprice, rts = _ag_chunks(rng, n, bs, 1_800_000_000_000)
    passed = int((rprice.astype(np.float32) < np.float32(700.0)).sum())
    runs = {k: [] for k in ks}
    for rnd in range(AG_RATE_ROUNDS):
        for k in ks:
            found = {}

            def record(rt, k=k, found=found, rnd=rnd):
                if k == 1 or rnd:
                    return
                pipe = rt.junctions["TradeStream"]._pipeline
                orig = pipe._superstep_dispatch

                def watched(block):
                    if "syncs" in found:
                        return orig(block)
                    out, syncs = call_watching_syncs(torch,
                                                     lambda: orig(block))
                    found["syncs"] = syncs
                    return out

                pipe._superstep_dispatch = watched

            blocks, arrivals, sent, elapsed, snap, la, _ = run_ag(
                torch, k, rchunks, bs, producers, record=record)
            n_out = sum(len(b[0]) for b in blocks)
            if snap["rows_in"] != n * bs or snap["rows_delivered"] != n * bs:
                raise Failure(f"app AG K={k} rate: {n * bs} sent, "
                              f"{snap['rows_in']} in, "
                              f"{snap['rows_delivered']} delivered to the "
                              "filter")
            if n_out != passed // WINDOW * WINDOW:
                raise Failure(f"app AG K={k} rate: {n_out} rows out for "
                              f"{passed} passing the filter")
            if k > 1 and (snap["superstep_decline"] is not None
                          or snap["supersteps_dispatched"] != n // k):
                raise Failure(f"app AG K={k} rate: "
                              f"{snap['supersteps_dispatched']} supersteps "
                              f"({snap['superstep_decline']})")
            src = (np.array([int(b[0].max()) for b in blocks])
                   - rts[0]) // bs
            lat = (arrivals - sent[src]) * 1e3
            syncs = found.get("syncs", [])
            if k > 1 and len(syncs) > 1:
                raise Failure(f"app AG K={k}: {len(syncs)} host syncs in "
                              f"one superstep ({syncs}); one readback "
                              "expected")
            run = {"events_per_sec": n * bs / elapsed,
                   "latency_ms_p50": float(np.percentile(lat, 50)),
                   "latency_ms_p99": float(np.percentile(lat, 99)),
                   "superstep_scan_ms": snap["superstep_scan_ms"],
                   "superstep_replay_ms": snap["superstep_replay_ms"],
                   "stage_ms": snap["stage_ms"],
                   "h2d_overlap_ratio": snap["h2d_overlap_ratio"],
                   "worker_utilization": snap["worker_utilization"]}
            if k > 1 and not rnd:
                run["host_syncs_one_superstep"] = syncs
            runs[k].append(run)
            print(f"app AG K={k} rate, round {rnd + 1}: {json.dumps(run)} "
                  f"[{card}]")
    rates = {}
    for k in ks:
        eps = [r["events_per_sec"] for r in runs[k]]
        rates[k] = {"events_per_sec": float(np.median(eps)),
                    "events_per_sec_runs": eps,
                    "latency_ms_p50": float(np.median(
                        [r["latency_ms_p50"] for r in runs[k]])),
                    "latency_ms_p99": float(np.median(
                        [r["latency_ms_p99"] for r in runs[k]])),
                    "chunks": n, "producers": producers,
                    "supersteps": n // k if k > 1 else 0}
        print(f"app AG K={k} rate over {AG_RATE_ROUNDS} runs (median, "
              f"runs min..max {min(eps):.1f}..{max(eps):.1f} events/s): "
              f"{json.dumps(rates[k])} [{card}]")
    return launches, rates


def ah_app(torch, rng, card: str, n: int = AH_EVENTS,
           rate_hz: float = AH_RATE_HZ) -> dict:
    """Phase 30: app AH, config 1's auto-flush path (bench.py:440): rows
    sent one at a time at ~rate_hz with auto_flush_ms=10, batch_size=256
    and no flush() call; every passing row must arrive, in order, exact;
    p50/p99 send-to-callback latency."""
    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager().create_siddhi_app_runtime(
        APP_AH, batch_size=256, auto_flush_ms=10)
    got, arrive = [], []

    def cb(evs):
        t = time.perf_counter()
        got.extend(evs)
        arrive.extend([t] * len(evs))

    rt.add_callback("OutStream", cb)
    rt.start()
    h = rt.get_input_handler("TradeStream")
    sym = np.array([f"S{k}" for k in rng.integers(0, N_SYMBOLS, n)],
                   dtype=object)
    price = rng.uniform(0.0, N_PRICE_HI, n)
    ts = 1_900_000_000_000 + np.arange(n, dtype=np.int64)
    sent = np.zeros(n)
    passed = np.nonzero(np.float32(700.0) > price.astype(np.float32))[0]
    try:
        for i in range(n):
            sent[i] = time.perf_counter()
            h.send((sym[i], float(price[i]), i), timestamp=int(ts[i]))
            time.sleep(1.0 / rate_hz)
        t_end = time.perf_counter() + 10.0
        while len(got) < passed.shape[0] and time.perf_counter() < t_end:
            time.sleep(0.005)
    finally:
        rt.shutdown()
    if len(got) != passed.shape[0]:
        raise Failure(f"app AH: {len(got)} of {passed.shape[0]} events "
                      "arrived without a flush()")
    g_ts = np.array([e.timestamp for e in got], dtype=np.int64)
    if not np.array_equal(g_ts, ts[passed]) or \
            [e.data[0] for e in got] != list(sym[passed]) or \
            not np.array_equal(np.array([e.data[1] for e in got],
                                        dtype=np.float32),
                               price[passed].astype(np.float32)):
        raise Failure("app AH: events differ from the oracle")
    lat = (np.array(arrive) - sent[g_ts - ts[0]]) * 1e3
    res = {"events": int(passed.shape[0]),
           "latency_ms_p50": float(np.percentile(lat, 50)),
           "latency_ms_p99": float(np.percentile(lat, 99))}
    print(f"app AH (auto-flush 10 ms, batch 256, {n} rows one at a time at "
          f"{rate_hz:.0f}/s): {json.dumps(res)} [{card}]")
    return res


# --------------------------------------------------------------------------- #
# phases 34-35: K4b, the dense key table, and the partitioned apps AI, AJ
# --------------------------------------------------------------------------- #

PART_SYMBOLS = 1_000
PART_BATCH = 8_192
PART_SLOTS = 1_024  # app AJ's partition_capacity
PART_LENGTH = 100
PART_BIG = 131_072  # K4b's largest batch
APP_PART = """
define stream TradeStream (symbol string, price double, volume long);
partition with (symbol of TradeStream) begin
  @info(name = 'q') from TradeStream[700.0 > price]#window.length(100)
  select symbol, sum(price) as total, avg(price) as ap, count() as n
  insert into OutStream;
end;
"""
K4B_FIELDS = ("sorted_keys", "sorted_ids", "count", "ids")


def k4b_edge_cases(torch, rng, dev, L: int = PART_BATCH, K: int = PART_SLOTS,
                   n_keys: int = PART_SYMBOLS, L_big: int = PART_BIG) -> dict:
    """name -> (table, keys, valid) of K4b's edges: app AJ's first batch
    (1,000 new keys into K = 1,024) and its steady state (every key
    found); L_big lanes into K = 64 and K = 4,096 (more new keys than K:
    the selection); L = 1; no valid lane; every key new (4,000 into K =
    4,096: the one-block sort at its largest); every key found (L_big
    lanes); keys equal to INT64_MAX and INT64_MIN; heavy repeats; count +
    n_new > K; a full table receiving smaller keys (eviction); 8,192
    distinct keys into K = 1,024. Tables are filled by the plain version."""
    from siddhi_tpu_torch.ops import groupby
    PAD = (1 << 63) - 1
    MIN = -(1 << 63)

    def keys_of(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

    def valid(n, p=0.95):
        return torch.from_numpy(rng.random(n) < p).to(dev)

    def table_with(k, pre):
        t = groupby.init_dense_key_table(k, dev)
        if len(pre):
            t, _ = groupby.dense_key_lookup_or_insert_plain(
                t, keys_of(pre), torch.ones(len(pre), dtype=torch.bool,
                                            device=dev))
        return t

    def distinct(n, lo=MIN, hi=PAD):
        return rng.choice(np.arange(n * 4, dtype=np.int64), n,
                          replace=False) * ((hi // (n * 4)) // 2) + lo // 2

    sym = rng.integers(MIN, PAD, n_keys, dtype=np.int64)  # K3 hashes' stand-in
    k4096 = distinct(4096)
    fresh = distinct(4000, lo=0)
    ext = np.array([PAD, PAD - 1, MIN, MIN + 1, 0, -1, 1, 1 << 62])
    evict = np.arange(1_000_000, 1_000_064)
    return {
        "app AJ's first batch": (table_with(K, []),
                                 keys_of(sym[rng.integers(0, n_keys, L)]),
                                 valid(L, 1.0)),
        "app AJ's steady state": (table_with(K, sym),
                                  keys_of(sym[rng.integers(0, n_keys, L)]),
                                  valid(L, 1.0)),
        "L = 131072, K = 64": (table_with(64, []), keys_of(rng.integers(
            MIN, PAD, 10_000, dtype=np.int64)[rng.integers(0, 10_000,
                                                            L_big)]),
            valid(L_big)),
        "L = 131072, K = 4096": (table_with(4096, k4096[:1000]), keys_of(
            np.concatenate([k4096[:1000], rng.integers(
                MIN, PAD, 49_000, dtype=np.int64)])[rng.integers(
                    0, 50_000, L_big)]), valid(L_big)),
        "L = 1": (table_with(K, sym[:10]), keys_of(fresh[:1]), valid(1, 1.0)),
        "no valid lane": (table_with(K, sym[:100]),
                          keys_of(sym[rng.integers(0, n_keys, L)]),
                          valid(L, 0.0)),
        "every key new": (table_with(4096, k4096[:96]),
                          keys_of(rng.permutation(fresh)), valid(4000, 1.0)),
        "every key found": (table_with(4096, k4096),
                            keys_of(k4096[rng.integers(0, 4096, L_big)]),
                            valid(L_big)),
        "INT64_MAX and INT64_MIN": (table_with(64, [MIN, -1, 0, PAD - 1]),
                                    keys_of(ext[rng.integers(0, 8, 4096)]),
                                    valid(4096)),
        "heavy repeats": (table_with(64, []), keys_of(rng.choice(
            [7, -7, 1 << 40], L_big)), valid(L_big)),
        "count + n_new > K": (table_with(64, fresh[:60]), keys_of(
            fresh[40:80][rng.integers(0, 40, 1000)]), valid(1000, 1.0)),
        "eviction": (table_with(64, evict), keys_of(np.concatenate(
            [rng.integers(-10**6, 10**6, 30), evict])[rng.integers(
                0, 94, 512)]), valid(512, 1.0)),
        "n_new past K": (table_with(K, []), keys_of(rng.permutation(
            distinct(L))), valid(L, 1.0)),
    }


def run_k4b_case(groupby, case, plain: bool, counter: str = "K4b"):
    """(sorted_keys, sorted_ids, count, ids) after the case's call, by the
    kernel or by the plain version (neither modifies its inputs)."""
    table, keys, valid = case
    fn = (groupby.dense_key_lookup_or_insert_plain if plain else
          lambda t, k, v: groupby.dense_key_lookup_or_insert(
              t, k, v, counter=counter))
    t, ids = fn(table, keys, valid)
    return (*t, ids)


def k4b_bytes(case) -> int:
    """What K4b must move: each lane's key (8 B) and valid flag (1 B)
    read and id (4 B) written, the table (12 B an entry) read and
    written."""
    table, keys, _ = case
    return keys.shape[0] * 13 + table.sorted_keys.shape[0] * 24


def dense_key_phase(torch, rng) -> dict:
    """Phase 34: K4b against its plain version at its edges, bit for bit
    (ids, sorted_keys, sorted_ids, count), one launch a call, the sizes
    alternating on one stream; timed at app AJ's shapes and the two
    selections; and K3 on app AJ's key column ("K3 partition")."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.ops import groupby
    dev = torch.device("cuda")
    cases = k4b_edge_cases(torch, rng, dev)
    order = list(cases) + ["L = 131072, K = 4096", "L = 1", "n_new past K",
                           "no valid lane", "L = 131072, K = 64",
                           "INT64_MAX and INT64_MIN", "app AJ's first batch"]
    for name in order:
        kernels.reset_launch_counts()
        got = run_k4b_case(groupby, cases[name], plain=False)
        if kernels.LAUNCHES["K4b"] != 1:
            raise Failure(f"K4b edge {name}: {kernels.LAUNCHES['K4b']} "
                          "launches, one a call expected")
        for f, a, b in zip(K4B_FIELDS, got,
                           run_k4b_case(groupby, cases[name], plain=True)):
            check_equal(f"K4b edge {name} {f}", a, b)
    print(f"K4b edges: {len(cases)} cases bit for bit (ids, sorted_keys, "
          "sorted_ids, count), one launch a call, sizes alternating on one "
          "stream")
    res = {}
    for row, name in (("K4b", "app AJ's steady state"),
                      ("K4b (app AJ's first batch)", "app AJ's first batch"),
                      ("K4b (L = 131072, K = 4096)", "L = 131072, K = 4096")):
        case = cases[name]
        kernels.reset_launch_counts()
        groupby.dense_key_lookup_or_insert(*case)
        launches = kernels.LAUNCHES["K4b"]
        res[row] = dict(
            _timed(torch, lambda c=case: groupby.dense_key_lookup_or_insert(
                       *c), lambda c=case:
                   groupby.dense_key_lookup_or_insert_plain(*c)),
            bound_ms=bound_ms(k4b_bytes(case)), max_abs_err=0,
            bound_by="bytes", launches_a_call=launches)
        print(f"{row} dense_key_lookup_or_insert {name} (L="
              f"{case[1].shape[0]}, K={case[0].sorted_keys.shape[0]}): "
              f"{json.dumps(res[row])}")
    codes = torch.from_numpy(rng.integers(1, PART_SYMBOLS + 1, PART_BATCH)
                             .astype(np.int32)).to(dev)
    check_equal("K3 partition",
                groupby.hash_columns([codes], counter="K3 partition"),
                groupby.hash_columns_plain([codes]))
    res["K3 partition"] = dict(
        _timed(torch, lambda: groupby.hash_columns([codes],
                                                   counter="K3 partition"),
               lambda: groupby.hash_columns_plain([codes])),
        bound_ms=bound_ms(PART_BATCH * (4 + 8)), max_abs_err=0,
        bound_by="bytes")
    print(f"K3 partition n={PART_BATCH} (int32 symbol codes): "
          f"{json.dumps(res['K3 partition'])}")
    torch.cuda.synchronize()
    return res


def part_events(rng, rounds: int = ROUNDS, batch: int = PART_BATCH,
                n_symbols: int = PART_SYMBOLS):
    """Apps AI and AJ's feed: 1,000 symbols, price uniform on [0, 1000),
    trades 1 ms apart."""
    n = rounds * batch
    sym = rng.integers(0, n_symbols, n)
    price = rng.uniform(0.0, N_PRICE_HI, n)
    volume = rng.integers(1, 1000, n).astype(np.int64)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return sym, price, volume, ts


def oracle_part(sym, price32, rounds: int = ROUNDS, batch: int = PART_BATCH,
                length: int = PART_LENGTH):
    """Apps AI and AJ: every passing event (700.0 > price, float32) emits
    its symbol's length(100) sum (float64), mean and count; each round's
    events ordered by the symbol's first appearance in the feed (its
    string code and its slot), then by arrival. Returns (indices, total,
    mean, count) in emission order."""
    n = sym.shape[0]
    keep = np.float32(700.0) > price32
    idx = np.nonzero(keep)[0]
    s, v = sym[idx], price32[idx].astype(np.float64)
    order = np.argsort(s, kind="stable")
    ss, vs = s[order], v[order]
    start = np.r_[True, ss[1:] != ss[:-1]]
    pos = np.arange(ss.shape[0])
    rank = pos - pos[start][np.cumsum(start) - 1]  # events of the symbol
    cs = np.cumsum(vs)
    back = np.where(rank >= length, pos - length, -1)
    base = np.where(rank >= length, cs[np.maximum(back, 0)],
                    (cs - vs)[start][np.cumsum(start) - 1])
    total = np.empty(idx.shape[0])
    count = np.empty(idx.shape[0], np.int64)
    total[order] = cs - base
    count[order] = np.minimum(rank + 1, length)
    first = np.full(sym.max() + 1, n)
    np.minimum.at(first, sym, np.arange(n))
    emit = np.lexsort((idx, first[s], idx // batch))
    return idx[emit], total[emit], total[emit] / count[emit], count[emit]


def check_part(name: str, got, want, pool, sym, ts) -> int:
    idx, total, mean, count = want
    if len(got) != idx.shape[0]:
        raise Failure(f"app {name}: {len(got)} events out, the oracle "
                      f"expects {idx.shape[0]}")
    g_ts = np.fromiter((e.timestamp for e in got), np.int64, len(got))
    if not np.array_equal(g_ts, ts[idx]):
        raise Failure(f"app {name}: timestamps or order differ from the "
                      "oracle")
    if [e.data[0] for e in got] != pool[sym[idx]].tolist():
        raise Failure(f"app {name}: symbols differ from the oracle")
    if not np.array_equal(np.fromiter((e.data[3] for e in got), np.int64,
                                      len(got)), count):
        raise Failure(f"app {name}: counts differ from the oracle")
    for what, col, o in (("total", 1, total), ("ap", 2, mean)):
        g = np.fromiter((e.data[col] for e in got), np.float64, len(got))
        if not np.allclose(g, o, rtol=RTOL, atol=0):
            bad = np.max(np.abs(g - o) / np.abs(o))
            raise Failure(f"app {name}: {what} off by rel {bad:.3g}")
    return len(got)


def run_part_app(torch, name: str, columns: dict, ts, mesh: bool,
                 rounds: int = ROUNDS, batch: int = PART_BATCH):
    """App AI (the per-key host loop) or AJ (the key-slot path on the card,
    partition_capacity 1,024): `rounds` sends of `batch` trades, a flush
    each, then one heartbeat. Returns (runtime, events, launches, elapsed
    s, peak bytes)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch import kernels
    rt = SiddhiManager().create_siddhi_app_runtime(
        APP_PART, batch_size=batch,
        mesh=[torch.device("cuda")] if mesh else None,
        partition_capacity=PART_SLOTS)
    pr = rt.partitions["partition1"]
    if (pr._mesh_step is not None) != mesh:
        raise Failure(f"app {name}: the partition took the wrong path")
    got = []
    rt.add_callback("OutStream", got.extend)
    h = rt.get_input_handler("TradeStream")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(rounds):
        s = slice(r * batch, (r + 1) * batch)
        h.send_columns({k: v[s] for k, v in columns.items()},
                       timestamps=ts[s])
        rt.flush()
    rt.heartbeat(int(ts[-1]) + 1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return (rt, got, dict(kernels.LAUNCHES), elapsed,
            torch.cuda.max_memory_allocated())


def part_reads(torch, rt, columns: dict, ts, batch: int = PART_BATCH):
    """One more round's route: (the host syncs in the partition's own code,
    the deliveries (K12a packs, each one wait for its copy), the sync
    sites)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.event import EventBatch
    j = rt.junctions["TradeStream"]
    s = slice(0, batch)
    cols = j.codec.encode_columns({k: v[s] for k, v in columns.items()},
                                  batch)
    b = EventBatch.from_numpy(ts[s], cols, batch, j.ctx.device)
    pr = rt.partitions["partition1"]
    kernels.reset_launch_counts()
    syncs = syncs_in(torch, lambda: pr.route("TradeStream", b,
                                             int(ts[-1]) + 2))
    own = sum(" from partition.py:" in x for x in syncs)
    if own != len(syncs):
        raise Failure(f"host syncs outside the partition's routing: {syncs}")
    return own, kernels.LAUNCHES["K12a"], sorted(set(syncs))


def partition_apps(torch, rng, card: str, rounds: int = ROUNDS) -> dict:
    """Phase 35: apps AI and AJ on one feed against the numpy oracle and
    each other as per-key sequences; K4b and "K3 partition" one launch a
    batch on AJ and none on AI; events/s, ms a round, host reads a batch,
    peak device memory. Returns the two apps' launches."""
    sym, price, volume, ts = part_events(rng, rounds)
    pool = symbols(PART_SYMBOLS)
    columns = {"symbol": pool[sym], "price": price, "volume": volume}
    want = oracle_part(sym, price.astype(np.float32), rounds)
    total = {}
    per_key = {}
    for name, mesh in (("AI", False), ("AJ", True)):
        rt, got, launches, elapsed, peak = run_part_app(
            torch, name, columns, ts, mesh, rounds)
        n_out = check_part(name, got, want, pool, sym, ts)
        seqs = {}
        for e in got:
            seqs.setdefault(e.data[0], []).append((e.timestamp, *e.data))
        per_key[name] = seqs
        del got
        expect = rounds if mesh else 0
        for k in ("K4b", "K3 partition"):
            if launches[k] != expect:
                raise Failure(f"app {name}: {launches[k]} {k} launches, "
                              f"{expect} expected (one a batch on the "
                              "key-slot path)")
        for k in ("K2b append", "K12a"):
            if launches[k] == 0:
                raise Failure(f"app {name}: kernel {k} never launched")
        own, delivery, sites = part_reads(torch, rt, columns, ts)
        # the count read, or the valid and key reads; one delivery, or
        # one a key present
        want_reads = ((1, 1) if mesh else
                      (2, np.unique(sym[:PART_BATCH]).shape[0]))
        if (own, delivery) != want_reads:
            raise Failure(f"app {name}: {own} host reads in the "
                          f"partition's routing and {delivery} deliveries, "
                          f"{want_reads} expected: {sites}")
        n = rounds * PART_BATCH
        path = ("key-slot path, 1,024 slots" if mesh
                else "per-key host loop")
        print(f"app {name} ({path}): "
              f"{n} events in, {n_out} out, matches the oracle; "
              f"{n / elapsed:.1f} events/s; {elapsed * 1e3 / rounds:.3f} ms "
              f"per {PART_BATCH}-event round; host reads a batch: {own} "
              f"in the routing ({sites}) + {delivery} deliveries; peak "
              f"device memory {peak / 2**20:.1f} MiB; kernel launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]")
        total.update({k: total.get(k, 0) + v for k, v in launches.items()})
        del rt
    if per_key["AI"].keys() != per_key["AJ"].keys():
        raise Failure("apps AI and AJ: different keys emitted")
    for k, a in per_key["AI"].items():
        b = per_key["AJ"][k]
        if len(a) != len(b) or any(
                x[:2] != y[:2] or x[4] != y[4]
                or not np.allclose(x[2:4], y[2:4], rtol=RTOL, atol=0)
                for x, y in zip(a, b)):
            raise Failure(f"apps AI and AJ: key {k}'s events differ")
    print(f"apps AI and AJ: equal as per-key sequences over "
          f"{len(per_key['AI'])} keys")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 3
    try:
        from siddhi_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke.py: the siddhi_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2

    try:
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        t0 = time.perf_counter()
        from siddhi_tpu_torch import native
        host_build = threading.Thread(target=native.load)  # beside nvcc
        host_build.start()
        logs = kernels.build_all()
        host_build.join()
        print(f"built {len(logs)} kernel libraries and the host encoder in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, log in logs.items():
            print(f"--- nvcc -Xptxas -v: {name}\n{log.strip()}")
        nat = native.load()
        print("host encoder: " + (f"native ({nat.__file__})" if nat
                                  else "Python"))
        if nat is None:
            raise Failure("the native host encoder did not build or load "
                          "(a C compiler and Python.h are needed)")

        rng = np.random.default_rng(args.seed)
        from siddhi_tpu_torch.ops.windows import LengthBatchWindow
        width_a = LengthBatchWindow({}, BATCH, WINDOW,
                                    expired_on=False).chunk_width
        kres = kernel_phase(torch, rng, width_a)
        # its own generator: the phases after it keep their inputs
        k1_edge_phase(torch, np.random.default_rng([args.seed, 2]))
        # its own generator: the phases after it keep their inputs
        keytable_edge_phase(torch, np.random.default_rng([args.seed, 4]))
        # its own generator: the phases after it keep their inputs
        scan_sort_edge_phase(torch, np.random.default_rng([args.seed, 31]))
        pattern_walk_edge_phase(torch,
                                np.random.default_rng([args.seed, 32]))
        pattern_probe_edge_phase(torch,
                                 np.random.default_rng([args.seed, 33]))
        merge_search_edge_phase(torch,
                                np.random.default_rng([args.seed, 36]))

        # every counter: the bounded argsort's default and bucket-order
        # sites run off the main path and have no row of their own
        launches = dict.fromkeys([*KERNELS, *kernels.LAUNCHES], 0)
        summary = {}  # the columnar async path, per app
        on_path = {"A": ("K1", "K5", "K12a", "K7 merge", "K7 K5 sort"),
                   "B": ("K1", "K3", "K4", "K5", "K12a", "K7 merge",
                         "K7 K5 sort")}
        for name, text, long_key in (("A", APP_A, False), ("B", APP_B, True)):
            key, price, volume, ts = make_events(rng, long_key)
            key_col = key if long_key else np.array(
                [f"S{k}" for k in key], dtype=object)
            columns = {("account" if long_key else "symbol"): key_col,
                       "price": price, "volume": volume}
            with counting_calls(K4_SITES) as k4:
                rt, got, app_launches, elapsed, peak = run_app(
                    torch, text, columns, ts)
            if name == "B":
                check_one_launch_a_call("B", app_launches, "K4",
                                        k4["calls"])
            passed = (price.astype(np.float32) > np.float32(20.0)
                      if long_key else np.ones(key.shape[0], bool))
            n_out = check_app(name, got, key_col, key, price, ts, passed,
                              long_key)
            for k in on_path[name]:
                if app_launches[k] == 0:
                    raise Failure(f"app {name}: kernel {k} never launched")
            for k in launches:
                launches[k] += app_launches[k]
            syncs, step_ms = measure_steps(torch, rt, columns, ts)
            report_app(name, key.shape[0], n_out, elapsed, step_ms, peak,
                       app_launches, syncs, card)
            del rt, got
            if name == "A":
                col = columnar_pair(
                    torch, "A", APP_A, round_sends("TradeStream", columns,
                                                   ts),
                    "SummaryStream", BATCH, ROUNDS,
                    lambda g: check_app("A", g, key_col, key, price, ts,
                                        passed, long_key),
                    elapsed, card, summary, gcap=GROUP_CAP)
                for k in launches:
                    launches[k] += col[k]
                python_encoder_run(
                    torch, "A", APP_A, columns, ts, "SummaryStream",
                    lambda g: check_app("A", g, key_col, key, price, ts,
                                        passed, long_key),
                    elapsed, card, summary)

        # its own generator for the merge and search rows: the phases
        # after it keep their inputs
        sres, routes = sliding_kernel_phase(
            torch, rng, np.random.default_rng([args.seed, 6]), width_a)
        kres.update(sres)
        print("torch routes: " + json.dumps(routes))
        for k, v in sliding_apps(torch, rng, card, summary).items():
            launches[k] += v

        kres.update(join_kernel_phase(torch, rng))
        # its own generator: app G keeps its feed
        multimap_edge_phase(torch, np.random.default_rng([args.seed, 8]))
        for k, v in join_app(torch, rng, card, summary).items():
            launches[k] += v

        kres.update(pattern_kernel_phase(torch, rng))
        # its own generator: apps H and I keep their feeds
        insert_edge_phase(torch, np.random.default_rng([args.seed, 10]))
        for k, v in pattern_apps(torch, rng, card, summary).items():
            launches[k] += v

        kres.update(aggregator_kernel_phase(torch, rng))
        for k, v in aggregator_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(wire_kernel_phase(
            torch, rng, edge_rng=np.random.default_rng([args.seed, 14])))
        for k, v in config1_app(torch, rng, card, summary).items():
            launches[k] += v

        kres.update(absent_kernel_phase(torch, rng))
        for k, v in absent_every_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(sort_kernel_phase(torch, rng))
        for k, v in session_sort_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(expression_kernel_phase(torch, rng))
        for k, v in expression_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(limiter_kernel_phase(torch, rng))
        for k, v in limiter_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(table_kernel_phase(
            torch, rng, rng13e=np.random.default_rng([args.seed, 13])))
        table_edge_phase(torch, np.random.default_rng([args.seed, 24]))
        for k, v in table_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(aggregation_kernel_phase(torch, rng))
        for k, v in aggregation_apps(torch, rng, card).items():
            launches[k] += v

        kres.update(superstep_kernel_phase(torch, rng))
        ag_launches, ag_rates = ag_app(torch, rng, card)
        for k, v in ag_launches.items():
            launches[k] += v
        summary["AG"] = ag_rates
        summary["AH"] = ah_app(torch, rng, card)
        print(json.dumps({"columnar": summary}))

        # its own generator: the phases after it keep their inputs
        kres.update(dense_key_phase(torch,
                                    np.random.default_rng([args.seed, 34])))
        for k, v in partition_apps(torch, rng, card).items():
            launches[k] += v

        table = []
        rows = [(k, k) for k in KERNELS] + list(EXTRA_ROWS.items())
        for k, counter in rows:
            fn, src, replaces = KERNELS[counter]
            r = kres[k]
            table.append({"name": f"{k} {fn}", "route": "cuda",
                          "source": src, "replaces": replaces,
                          "launches": launches[counter],
                          "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                          "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"],
                          "library_ms": r["library_ms"],
                          "call_ms": r.get("call_ms")})
        print("library calls that synced with the host: "
              f"{LIBRARY_SYNCS or 'none'}")
        print(json.dumps({"kernels": table}))
        print(f"card: {card}")
    except Failure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
