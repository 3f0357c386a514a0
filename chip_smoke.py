#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (featurebase_tpu_torch) on a GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--shards 128] [--reps 20]

Phases, one status line each; any failure raises and exits nonzero:
  1. the card (nvidia-smi name, power limit and maximum SM clock) and the
     torch/CUDA versions;
  2. build of every CUDA source with nvcc (sm_90a), and of the ablation
     builds, all at once, timed, with the ptxas register/stack/spill report
     of each kernel (it fails if plan_eval_kernel, a BSI kernel, a GroupBy
     kernel, a decode kernel or a form of H' spills or keeps a stack
     frame);
     cuobjdump's SASS of each tuning kernel must keep the 16-byte loads of
     its main loop;
  3. each kernel against its plain PyTorch version on the card, at the
     slice's shapes, on random words from a numpy seed: exact equality.
     Kernel A on every program shape the main path makes: AND, BSI `>`,
     `between` at depth 14 and at depth 32 (34 planes, 16 shards), word
     mode, a program of every opcode, the flat S = 1 count_and over 2^22
     words, and the 1,000,003-word scalar path; and in each of its forms
     (register file 2, 4 or 12; staged or scalar).  Kernel B'
     (row_counts) over stacked tiles at S and 1, and over address tables
     of per-shard tiles (row_table_parity): slot -1, shards without a tile,
     filter words, filter rows with a shard's missing, no filter, W = 32768,
     1001 and 37, S = 1, 5, 32 and 128, and 150 rows.  Kernels C' and D'
     (bsi_sum_planes, bsi_min_max; D' as a Min and as a Max) on random
     groups at the slice's shape and on encoded values at depths 1, 14, 31,
     32 and 63: ties across shards, sign-set zeros, all-negative groups,
     empty and all-ones filters, an odd W and S = 131 and 7; stacked,
     through strided views (the affine table, 16- and 4-byte forms), and
     over address tables of per-shard mirrors (bsi_sharded_cases: planes
     out of order, absent planes, a shard without data, None filter rows,
     S = 1 at depths 1-63, 2 at depth 43, 7 at W = 1001, 128 and 131).
     Kernels E and F (pair_counts, bsi_sum_groups; `group_parity`; the
     product on the tensor cores' 1-bit form): over stacked operands, E
     at S = 1, 32 and 128 with F and R each 1, 8 and 33, with and without
     a filter, F at depths 1, 14, 31, 32 and 63 with G = 1, 8, 32 and 33
     at S = 1 and 32, both at an odd W, on all-ones words, empty masks and
     sign-only columns; over per-shard tiles read in place (one launch over
     every shard), absent rows, a shard without a tile, one to three
     dimensions, 512 groups, filters as words, as per-shard rows and viewed
     one word into a wider row (the 4-byte path), and D = 1 to 63.  Kernels
     G'', G''' and I' (decode_parity): G'' and G''' stacked and over
     address tables of per-shard mirrors (planes out of order, absent
     planes, a shard without data, views one word off, S = 1 to 131,
     W = 32768 and 1001, depths 1, 14 and 31, G''' at N = 0, 1, 37 and
     65,536 columns a shard), I' in each of its forms at K = 0, 1, 2,
     129 and 512 thresholds: random, duplicated, every value below them,
     every value above them, and bases that wrap value + base in int32.
     Kernel H' (var_moments, corr_moments; moments_parity): Var at depths
     1, 5, 14 and 31 and Corr at (1, 1), (5, 3), (14, 12) and (31, 31), at
     S = 1 and 3 and at the slice's S, with absent planes, planes not under
     exists, encoded values, all-ones and empty filters, W = 1001 and a
     view one word off (the 4-byte forms), stacked and over per-shard
     mirrors with the filter as words, as rows with some None, and absent;
  4. kernel times (CUDA events, L2 flushed before each launch, median of
     --reps; and each CUDA kernel's own device time from torch.profiler)
     beside the bound (bytes at 3.35 TB/s or, for E and F, bit products at
     the tensor cores' measured rate when that is longer), the measured
     device-to-device copy ceiling and the plain version's time (kernels C'
     and D' at depth 14, 128 shards and one shard, at depth 43 over two
     shards, and in one launch over 128 shards' mirrors beside the 128
     one-shard launches it replaces; B' stacked at S = 128 filtered and
     not, at S = 1, and in one launch over 128 shards' mirrors beside the
     128 one-shard launches it replaces; E and F at the main path's
     one-launch shapes over 128 shards, beside 128 launches of one shard
     each, and at the stacked shapes of the earlier slices; G'' stacked
     and over 128 shards' mirrors beside 128 one-shard launches, G''' at
     1,000 and 65,536 columns of a shard and over 128 shards' mirrors
     beside 128 one-shard launches, I' at its prep pass and at rounds of 2
     and 129; H for Var at depth 14 and Corr at depths 14 and 12 over S
     stacked shards, moments_times); the card's popcount rate
     from a popcount-only loop and the tensor cores' rate in the 1-bit and
     int8 mma.sync forms (`tc_rate`, with whether ptxas takes the
     warpgroup 1-bit form, csrc/wgmma_b1_probe.cu); kernel A's cases must run
     its form (staged by TMA, or scalar for the irregular cases), and a
     count case with a Memset fails; then kernel A's staged cases under
     the two ablation builds, one without its copies and one without its
     program; B' built with its rows staged by TMA bulk copies beside the
     default's direct loads (row_ablation), I' built with its search a
     lift over every threshold beside the default's bucket table
     (pct_ablation), and H' without its copies and without its product at
     S = 128 (moments_ablation);
  5. the slice: a --shards table (625,000 records per shard; set fields f
     and g, int fields v in [-1000, 10000] and u in [-500, 4000], a third
     of v plus noise on nine records in ten) built through the port's
     import API, the query mix (Count, Row, TopN, Sum, Min, Max, MinRow,
     MaxRow, Rows, UnionRows, Limit, GroupBy, Var, Corr, and calls only the
     per-shard interpreter runs), and LIMIT_QUERIES over a small second index (plans
     past kernel A's limits, BSI predicates at depth 43), through
     Executor(holder) on cuda, every answer equal to a numpy oracle on
     Count(Intersect), Count(Row(v > 5000)), TopN(f, n=5), Sum(field=v),
     Min(field=v), Max(Row(g=2), field=v), Min and Max under the
     unplannable Union(Row(g=1), Row(f=null)) (one sharded D' launch each),
     the two per-shard GroupBys (count, and Sum of v) and the decode
     family (decode_oracles: Distinct and Sort under the unplannable
     union, one sharded G'' launch each, and Extract of the
     records with v == 42, one G''' launch over every shard), Var and
     Corr on kernel H''s route exactly (numpy's integer moments finished
     by the executor's own Executor.var_of and corr_of) and every one
     within a tolerance of numpy's float64, and every answer that no exact
     oracle holds equal to a CPU executor's over the same table (a worker
     process, CPUWorker, started before the builds, builds the table again
     and computes the oracles and the CPU answers on the host's cores
     while this process drives the card; it is stopped while the kernels
     are timed, phase 4 and the ablations); every
     kernel's
     launch counter must rise, by
     pass_launches() a pass of the full mix;
     TopN's per-shard branch must give the stacked answers; p50 latency per
     query (runs_for: 20 runs below 20 ms, 10 to 200 ms, 3 past it);
     then a pass under torch.profiler, each query labelled: each
     kernel's device time and the device-busy share of each query and
     of the pass, and every launch the profiler could not link; then the
     residency phase: every device cache dropped, and the whole mix again
     under a residency budget of half the bytes the first pass left
     resident, with every answer unchanged, evictions, and the bytes
     within the budget after each query; then the writes phase, after
     every read: PQL Set, Clear, ClearRow, Store and Delete on the bench
     and keyed indexes after reads that filled every device cache, then
     the reads again, each equal to a numpy model of the writes (Var and
     Corr exactly, from numpy's integer moments), and each that the model
     does not hold equal to the CPU executor, at the default budget and
     again under half the
     resident bytes; the p50 of a Set, Store and Delete and the first
     read after the writes beside the cached p50; then the api phase
     (api_phase), through featurebase_tpu_torch.server.api.API on the
     card: the whole mix through API.query, launch counters set to 0 just
     before and read just after (every kernel must run), each answer equal
     to an Executor's over the written table, and the API's host overhead
     beside the Executor in turns; Apply(Intersect(Row(f=1), Row(g=2)),
     "v * 2 + u") over about 2.5 M records and its five reduces against
     numpy, with one kernel-A launch and one G''' launch a field, and the
     reduces' p50 and busy share; Arrow over 100,000 dataframe rows and
     ExternalLookup over a sqlite3 table against numpy; a 16-shard table
     with a data directory: imports, PQL writes, checkpoint, more writes,
     and a second API over the directory answering as the first (save,
     load and replay seconds); last, g deleted and created again on the
     warm API, its copies' residency bytes released and its new Count and
     TopN equal to numpy (`--only api` runs the table and this phase
     alone); then the sql phase (sql_phase), through
     featurebase_tpu_torch.sql.engine.execute_sql on the card: each
     statement of the pushdown mix (SQL_PUSHDOWN: COUNT under bitmap and
     BSI filters, SUM and AVG, MIN and MAX, PERCENTILE, VAR, CORR, both
     GROUP BY forms, COUNT(DISTINCT), SELECT DISTINCT, a scan and a scan
     with a residual filter) equal to its PQL counterpart through
     API.query and launching the same kernels (counters set to 0 around
     each), the numpy-held ones equal to the model; an INSERT of 1,000
     records and two DELETEs through SQL, and the numpy-held statements
     again (first read beside the cached p50); the dialect corpus
     (SQL_DIALECT) on the card and on the CPU, answers and error statuses
     equal; SQL's p50 beside its counterpart's, and a profiled pass
     (`--only sql` runs the table and this phase alone); then the mesh
     phase (mesh_phase), through featurebase_tpu_torch.parallel: an
     Executor over a mesh of every card, or of four members on one card,
     runs MESH_QUERIES (every family of the dry run) at every shard and
     at 125 shards, each answer equal to the single-device Executor's,
     launch counters set to 0 around its first pass (every kernel must
     run; its launches are added to the kernels line), each query's
     launches a member and p50 beside the single device's in turns; the
     port's dryrun_multichip over the same members; two ranks of
     tests/torch_multihost_worker.py through torch.distributed (Gloo on
     one card, NCCL on two), owner-placed, against numpy, both joined
     before the processes check (`--only mesh` runs the table and this
     phase alone); then the server phase (server_phase), through
     featurebase_tpu_torch.server: the mix over HTTP through the port's
     client (bitmaps wider than 100,000 columns stay in process), each
     body equal to the in-process JSON, the launch counters set to 0
     around the HTTP pass and around the same queries through API.query,
     equal (the HTTP pass's launches are added to the kernels line);
     SQL_PUSHDOWN over HTTP and statements and PQL calls over gRPC, unary
     and streamed, equal to the in-process answers; four HTTP and four
     gRPC client threads against the serial answers, then a second such
     pass sampled by utils/profiling.py's wall-clock profiler (the
     innermost frames of the servers' request threads); the wire layer's p50
     over API.query; `python -m featurebase_tpu_torch server` as a child
     process over the api phase's 16-shard directory with token auth (a
     reader's read, its write refused with 403), joined before the
     processes check (`--only server` runs the table and this phase
     alone); then the ingest phase (ingest_phase), through
     featurebase_tpu_torch.ingest, native/ and utils/pool.py, the launch
     counters set to 0 around it (its reads' launches are added to the
     kernels line): (a) every view of every field of 16 shards of the
     bench table exported through the C++ roaring codec and imported
     shard by shard into a fresh index of a card API, the mix over those
     shards equal on both, one shard's payloads equal between the C++
     and the Python codec, codec MB/s; (b) datagen's customer source,
     2,097,152 records, into a card API and a CPU API, five calls equal
     to each other and to numpy over generate_batches' arrays; (c)
     262,144 kitchen-sink records through the in-process Kafka broker,
     the Ingester into a durable card API, crashed after an import and
     before its commit and resumed from its directory, every record once
     and the answers equal to load_index's; (d) one shard's BSI delta of
     625,000 records (1% of columns twice) built on the card under
     FEATUREBASE_TPU_DEVICE_INGEST=1 equal to the host OR at depths 14
     and 31, the host OR at 32; (e) the mix's unplannable-filter queries
     and its Extracts (on the submitting thread) and its Sort past depth
     31 (host jobs on the worker pool), each with
     the pool and with a serial map patched in, in turns; one shard's
     HTTP /import-roaring and /export round trip (`--only ingest` runs
     the table and this phase alone); then the cluster phase
     (cluster_phase), through featurebase_tpu_torch.cluster and
     featurebase_tpu_torch.testing: (a) three in-process nodes with two
     replicas, each an API on the card, the bench index loaded through
     node 0's import_roaring_shard (a call a shard, the holder's roaring
     export forwarded over HTTP to the owners), CLUSTER_QUERIES through
     node 0's HTTP equal to the single device's answers, the first pass
     with each node's legs one at a time under the launch counters (every
     kernel must rise; the pass's launches, summed over the nodes, are
     added to the kernels line), SERVER_TIMED's p50 of 20 runs (5 past
     200 ms) beside the server phase's single-node HTTP p50, the JSON
     bytes and encode and decode ms of each node's partial of Row(f=3), a
     keyed
     index written and read through its key's partition primary, node 2
     stopped and CLUSTER_FAILOVER answered by the surviving replicas (the
     first pass after the failover timed), a Set through node 1 read back
     from both owners of its shard, and the device bytes held; (b) three
     `python -m featurebase_tpu_torch server --cluster-nodes` processes
     over 16 shards of the bench index (loaded through node 0's HTTP
     roaring import), CLI_QUERIES through nodes 0 and 2 equal to the
     single device's over those shards, then `backup --host` and
     `restore --host` into a fresh `server` process with the same answers
     (`--only cluster` runs the table and this phase alone); then the dax
     phase (dax_phase), through featurebase_tpu_torch.dax: (a) a
     DaxService of two computers, each an API on the card, over a
     temporary directory; (b) the bench index loaded through the queryer's
     import_roaring_shard, a call a shard, from the cluster phase's
     payloads; (c) the cluster phase's queries through the queryer's HTTP
     equal to the single device's, the first pass's launches charged to
     each computer (every kernel must rise; they are added to the kernels
     line); (d) SERVER_TIMED's p50 beside the cluster's and the single
     node's; (e) /dax/snapshot on every computer, timed, with its MB; (f)
     computer 1 stopped and the time until the poller has moved its shards
     and CLUSTER_FAILOVER answers as before (the time to recover); (g) a
     computer added, the time until it holds its share with the answers
     unchanged, no mirror left on computer 0 of the shards it gave up; (i)
     `python -m featurebase_tpu_torch dax` as a child over 16 shards, a
     few CLI_QUERIES equal to the single device's, and (h) a PQL Set and a
     roaring replace import through its queryer, both read back after the
     child is stopped by a service started cold over its directory; (j)
     the device bytes held (`--only dax` runs the table and this phase
     alone); a
     phase_seconds line gives each phase's wall time;
  6. the count-and tuning kernels (csrc/tune_count.cu) against their plain
     versions on the card at every launch shape, on the harness's 256 MB
     streams and on smaller ones, with a nonzero and a wrapping acc: exact
     equality mod 2^32;
  7. the tuning harness (featurebase_tpu_torch.tools.tune_count_kernel):
     its default variant list through `measure`, 256 MB a stream, launch
     counters reset before and read after (each tuning kernel must run),
     the two-stream read ceiling beside the copy ceiling; then each tuning
     kernel at its best shape timed like phase 4, at 256 MB and at the
     slice's (S, W) beside plan_eval's AND;
  8. kernels C' and D' beside the two-stream read ceiling of phase 7;
  9. no process started by the run is left running.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Without CUDA it exits nonzero at once.
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import subprocess
import sys
import signal
import time
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
# 32-bit popcounts a clock per SM (CUDA programming guide, arithmetic
# instruction throughput, compute capability 9.0)
POPC_PER_CLOCK_PER_SM = 16
RECORDS_PER_SHARD = 625_000
WGMMA_PROBE_SOURCE = "wgmma_b1_probe.cu"
SHARDS_0_31 = ", ".join(str(s) for s in range(32))
PER_SHARD_SUM = (f"per_shard:Options(GroupBy(Rows(f), Rows(g), "
                 f"aggregate=Sum(field=v)), shards=[{SHARDS_0_31}])")
QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=3)))",
    "Count(Difference(Row(f=1), Row(g=0)))",
    "Count(Xor(Row(f=1), Row(g=1)))",
    "Count(Not(Row(f=1)))",
    "Count(Row(v > 5000))",
    "Count(Row(v <= -10))",
    "Count(Row(v == 42))",
    "Count(Row(0 < v < 100))",
    "Count(Intersect(Row(f=1), Row(v > 5000)))",
    "Count(Shift(Row(f=1), n=1))",
    "Row(f=3)",
    "TopN(f, n=5)",
    "TopN(f, Row(g=2), n=5)",
    "TopN(f, Row(v > 5000), n=5)",
    "Options(Count(Row(f=1)), shards=[0, 5, 63])",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
    "Min(field=v)",
    "Max(Row(g=2), field=v)",
    "Min(Row(v > 5000), field=v)",
    "MinRow(field=f)",
    "MaxRow(field=f)",
    "Rows(f)",
    "Rows(f, column={col5})",
    "UnionRows(Rows(g))",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    f"Options(GroupBy(Rows(f), Rows(g), filter=Row(v > 5000)), "
    f"shards=[{SHARDS_0_31}])",
    f"Options(GroupBy(Rows(f), aggregate=Sum(field=v)), "
    f"shards=[{SHARDS_0_31}])",
    "GroupBy(Rows(f), Rows(g), having=Condition(count > 2500000))",
    "Count(Union(Row(f=1), Row(f=null)))",
    "Sum(Row(f=null), field=v)",
    "Min(Union(Row(g=1), Row(f=null)), field=v)",
    "Max(Union(Row(g=1), Row(f=null)), field=v)",
    "Options(Limit(Row(f=3), limit=5, offset=2), shards=[0])",
    # the per-shard level-wise GroupBy loop: at the default caps for one
    # dimension under a filter the plan compiler refuses; with both GroupBy
    # caps at 0 (PER_SHARD) for two dimensions, counted, and summed over
    # shards 0-31 (the CPU executor's plain sums over every shard would
    # take a seventh of the script)
    "GroupBy(Rows(f), filter=Union(Row(g=1), Row(f=null)))",
    "per_shard:GroupBy(Rows(f), Rows(g))",
    PER_SHARD_SUM,
]
# the decode family: Distinct (a call, under Count, as an operand, as
# GroupBy's aggregate), Percentile, Sort (a second page through the cursor
# after the first), Extract, IncludesColumn and FieldValue; Distinct and
# Sort under filters the plan compiler refuses (one kernel-G'' launch over
# every shard's mirror) and Extract of about 7,300 records spread over
# every shard (one kernel-G''' launch)
DECODE_QUERIES = [
    "Distinct(field=v)",
    "Distinct(Row(f=1), field=g)",
    "Count(Distinct(field=v))",
    "Count(Intersect(Row(f=1), Distinct(Row(g=2), field=f)))",
    "GroupBy(Rows(g), aggregate=Count(Distinct(field=v)))",
    "Percentile(field=v, nth=50)",
    "Percentile(field=v, nth=99.9, filter=Row(f=1))",
    "Percentile(field=v, nth=0)",
    "Percentile(field=v, nth=100)",
    "Sort(Row(f=1), field=v, limit=10)",
    "Sort(All(), field=v, sort-desc=true, limit=5, offset=3)",
    "Sort(All(), field=v, sort-desc=true, limit=5, after={after})",
    "Extract(Limit(Row(f=1), limit=1000), Rows(f), Rows(g), Rows(v))",
    "IncludesColumn(Row(f=1), column={col5})",
    "FieldValue(field=v, column={col5})",
    "Distinct(Union(Row(g=1), Row(f=null)), field=v)",
    "Sort(Union(Row(g=1), Row(f=null)), field=v, limit=10)",
    "Extract(Row(v == 42), Rows(v), Rows(g))",
]
QUERIES += DECODE_QUERIES
# Var and Corr: kernel H over the stacked groups (v, depth 14; u, depth 12)
# under no filter and filters the plan compiler takes; the float64 host
# route under a filter it refuses and past depth 31 (w, depth 43)
MOMENT_QUERIES = [
    "Var(field=v)",
    "Var(field=v, filter=Row(f=1))",
    "Var(field=v, filter=Row(v > 5000))",
    "Corr(field=v, field2=u)",
    "Corr(field=v, field2=u, filter=Row(g=2))",
    f"Options(Var(field=v, filter=Union(Row(g=1), Row(f=null))), "
    f"shards=[{SHARDS_0_31}])",
    "limits:Var(field=w)",
    "limits:Corr(field=w, field2=a)",
]
QUERIES += MOMENT_QUERIES
PER_SHARD = "per_shard:"
# Plans past kernel A's limits and BSI walks past 32 planes, over the small
# "limits" index (limits_index): 3000 records over two shards, a set field
# f of 60 rows, int fields a and b in [0, 2^30] and w at depth 43, a set
# field g on half the records.
UNION50 = "Union(" + ", ".join(f"Row(f={i})" for i in range(50)) + ")"
CHAIN13 = "Row(f=12)"
for _i in range(11, -1, -1):
    CHAIN13 = f"{'Union' if _i % 2 == 0 else 'Intersect'}(Row(f={_i}), " \
        f"{CHAIN13})"
LIMIT_QUERIES = [
    f"Count({UNION50})",
    f"TopN(f, {UNION50}, n=3)",
    f"Sum({UNION50}, field=a)",
    "Count(Intersect(Row(a > 5), Row(b > 5)))",
    f"Count({CHAIN13})",
    "Count(Row(w > 5))",
    "Count(Intersect(Row(w > 5), Row(g=null)))",
    # the decode family past depth 31: the host decode and the host
    # bisection over Counts
    "Distinct(field=w)",
    "Sort(All(), field=w, limit=5)",
    "Extract(Limit(All(), limit=20), Rows(f), Rows(w))",
    "Percentile(field=w, nth=50)",
]
QUERIES += [f"limits:{q}" for q in LIMIT_QUERIES]
# Extract and Distinct on a keyed index (keyed_index): record keys, a keyed
# set field translated to row keys, an unkeyed one left numeric
KEYED_QUERIES = [
    "Extract(All(), Rows(kf), Rows(n))",
    "Distinct(field=kf)",
    "Distinct(field=s)",
    "Sort(All(), field=n, limit=3)",
]
QUERIES += [f"keyed:{q}" for q in KEYED_QUERIES]


def pass_launches(S: int, percentile_rounds: int) -> dict:
    """Kernel launches in one pass of the full mix over S shards: kernel A
    19 times for the Count, TopN and aggregate queries, 4 for UnionRows'
    rows, once each for the stacked GroupBy's filter, the interpreter's
    Count and Limit, and 13 for the first seven LIMIT_QUERIES (a spill and
    the query for the 50-row union under Count, TopN and Sum and for the
    two 32-plane groups; once for the chain and the depth-43 Count; once a
    shard and the Count for the interpreter's depth-43 row); kernel B three
    times for TopN and once more for the union's, once each for MinRow and
    MaxRow (one launch over every shard's mirror), once each for Rows(f),
    Rows(g) in UnionRows and GroupBy(Rows(f)), and once for each of the
    three per-shard GroupBys (level 0 of every shard); kernel C' twice
    and once for the union, and once over every shard's mirror for the Sum
    under the unplannable filter; kernel E once for each GroupBy of f and g
    (one launch over every shard, or stacked), once for the stacked one of
    32 shards, and
    once a shard for each per-shard GroupBy of f and g (level 1); kernel F
    once for GroupBy+Sum, once for the stacked one, and 32 times for the
    per-shard GroupBy+Sum.
    The decode family adds: kernel A once for each filter of Distinct,
    Percentile, the three Sorts, the keyed Sort and the two Extracts' Limits,
    twice under the Distinct operand (its filter and the Count), once for
    each of the 4 groups of GroupBy's Count(Distinct), and 56 times for the
    depth-43 Percentile's host bisection (its Counts; the limits index draws
    from its own seed); kernel B once for each set-field Distinct (3 on the
    bench index, 2 on the keyed one); kernel D' for that bisection's Min
    and Max, besides three times for Min and Max and once each over every
    shard's mirror for the Min and the Max under the unplannable filter;
    kernel G'' once for the bench index's stacked decode (cached for every
    later query), once for the keyed index's, and once each over every
    shard's mirror (one residency batch at the default budget) for Distinct
    and Sort under Union(Row(g=1), Row(f=null)); kernel
    G''' once for each Extract up to depth 31 (the bench index's two, the
    keyed index's), over every shard it reaches; kernel I once for each
    round of the four Percentiles (percentile_rounds, from
    oracle_percentile).  The filter of Extract(Row(v == 42)) adds one
    kernel-A launch (the other two new queries' filters run on the
    interpreter).
    MOMENT_QUERIES add kernel H once for each of the three Vars and the two
    Corrs on the stacked route, and kernel A once for each of their three
    filters (Row(f=1), Row(v > 5000), Row(g=2)); the union-filtered Var
    and the depth-43 ones sum on the host."""
    return {"plan_eval": 113, "row_counts": 17,
            "bsi_sum_planes": 4, "bsi_min_max": 7,
            "pair_counts": 35 + S, "bsi_sum_groups": 34,
            "bsi_decode": 4, "bsi_decode_gather": 3,
            "percentile_counts": percentile_rounds,
            "var_moments": 3, "corr_moments": 2}


T0 = time.perf_counter()
LOG: list = []   # an open file that every status line is copied to (--log)
# each phase's wall seconds, in the order they ran (lap)
PHASE_SECONDS: dict = {}
_LAP = [T0]


def lap(name: str) -> None:
    """Charge the seconds since the previous lap to phase `name`."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + now - _LAP[0]
    _LAP[0] = now


def say(phase: str, **kw) -> None:
    """One status line: the phase, its fields and the seconds since the
    script started."""
    line = json.dumps({"phase": phase, **kw,
                       "t": round(time.perf_counter() - T0, 1)})
    print(line, flush=True)
    for fh in LOG:
        fh.write(line + "\n")
        fh.flush()


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm, in MHz)."""
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def child_pids() -> list:
    """Processes started by this one that still run (Linux /proc)."""
    pids = []
    for path in glob.glob("/proc/self/task/*/children"):
        with open(path) as fh:
            pids += [int(p) for p in fh.read().split()]
    return pids


# -- timing -------------------------------------------------------------------

class Timer:
    """Median device time of a callable with CUDA events.  Before each
    launch a 128 MB write evicts the 50 MB L2, so inputs come from HBM, and
    a spin kernel keeps the card busy while the host records the start
    event and enqueues the call, so host time in the wrapper is not
    counted.  A run first warms up, untimed; SLOW_PLAIN's first run is one
    of its three (a plain version over 128 shards takes 0.06-3 s a run)."""

    def __init__(self, reps: int, warm: bool = True):
        self.reps = reps
        self.warm = warm
        self.flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn) -> float:
        if self.warm:
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)   # ~0.5 ms of device time
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def slow_plain_ms(fn) -> float:
    """A slow plain version's median of 3 runs, the first among them."""
    return Timer(3, warm=False)(fn)


PROFILE_ATTEMPTS = 10   # profiler windows tried before a kernel time fails


def kernel_device_ms(fn, reps: int) -> dict:
    """Device time per launch of each CUDA kernel that `fn` runs, from
    torch.profiler (CUPTI), L2 flushed before each call: the kernels alone,
    without the launch gaps that the event timing includes."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    # The profiler drops some or all of a window's device events now and
    # then (tools/profiler_windows.py counts them), and in some windows
    # one fill of the flush every time.  So a window counts only when
    # another window of the same call held the same kernels the same
    # number of times: lost events are not lost alike twice.  At most
    # PROFILE_ATTEMPTS windows are taken.
    seen = []
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        sig = sorted((ev.key, ev.count) for ev in events
                     if ev.device_time_total > 0)
        if sig and sig in seen:
            break
        if seen:
            say("profiler_windows_differ", reps=reps, window=attempt,
                events=sum(n for _, n in sig),
                earlier=[sum(n for _, n in x) for x in seen])
        seen.append(sig)
    else:
        raise AssertionError(f"torch.profiler: no two of {PROFILE_ATTEMPTS} "
                             "windows held the same device events")
    names = ("plan_eval_kernel", "row_counts_kernel", "bsi_sum_planes_kernel",
             "bsi_min_max_kernel", "pair_counts_kernel",
             "bsi_sum_groups_kernel", "moments_kernel",
             "bsi_decode_gather_kernel",
             "bsi_decode_kernel", "percentile_counts_kernel",
             "tune_ceiling_kernel",
             "tune_csa_scalar_kernel", "tune_direct_partial_kernel",
             "tune_csa_partial_kernel", "Memset", "Memcpy")

    def short(key: str) -> str:
        """A kernel's name with its template arguments (kernel A's form)."""
        for n in names:
            i = key.find(n)
            if i >= 0:
                j = key.find(">", i) if key[i + len(n):].startswith("<") \
                    else -1
                return key[i:j + 1] if j > 0 else n
        return key[:60]
    out = {}
    for ev in events:
        if ev.device_time_total > 0 and "FillFunc" not in ev.key:
            k = short(ev.key)
            out[k] = out.get(k, 0.0) + ev.device_time_total / ev.count / 1e3
    return out


def rand_words(rng, shape) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).cuda()


def bsi_gt_program(bsi: torch.Tensor, pred: int):
    from featurebase_tpu_torch.ops import bsi_traced as bst
    from featurebase_tpu_torch.ops import lowering
    depth = bsi.shape[1] - 2
    bits, neg = bst.encode_pred(pred, depth)
    return lowering.program(bst.expr_gt(bst.LeafPlanes("v", bsi), bits,
                                        int(neg), depth, False),
                            bsi.shape[0], bsi.shape[2])


def between_program(bsi: torch.Tensor, lo: int, hi: int):
    """lo <= v <= hi, as Row(lo - 1 < v < hi + 1) lowers."""
    from featurebase_tpu_torch.ops import bsi_traced as bst
    from featurebase_tpu_torch.ops import lowering
    depth = bsi.shape[1] - 2
    lb, ln = bst.encode_pred(lo, depth)
    hb, hn = bst.encode_pred(hi, depth)
    return lowering.program(bst.expr_between(bst.LeafPlanes("v", bsi), lb,
                                             int(ln), hb, int(hn), depth),
                            bsi.shape[0], bsi.shape[2])


def and_program(a: torch.Tensor, b: torch.Tensor):
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    pb = ck.ProgramBuilder(*a.shape)
    r = pb.op(ck.OP_AND, pb.load(pb.plane(0, a)), pb.load(pb.plane(1, b)))
    return pb.build(r)


def word_program(a: torch.Tensor):
    """One load, as Row(f=3) runs in word mode."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    pb = ck.ProgramBuilder(*a.shape)
    return pb.build(pb.load(pb.plane(0, a)))


def every_op_program(a: torch.Tensor, b: torch.Tensor, bsi: torch.Tensor):
    """One program that runs every opcode, OP_BSI in each mode."""
    from featurebase_tpu_torch.ops import bsi_traced as bst
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    depth = bsi.shape[1] - 2
    pb = ck.ProgramBuilder(*a.shape)
    ra, rb = pb.load(pb.plane("a", a)), pb.load(pb.plane("b", b))
    leaf = bst.LeafPlanes("v", bsi)
    _, ex_key, ex = leaf.exists()
    first = [pb.plane(p[1], p[2]) for p in leaf.mags(0, depth)][0]
    acc = pb.op(ck.OP_AND, ra, rb)
    pb.op(ck.OP_OR, acc, pb.op(ck.OP_XOR, ra, rb), dst=acc)
    pb.op(ck.OP_ANDNOT, acc, pb.op(ck.OP_NOT, rb), dst=acc)
    pb.op(ck.OP_XOR, acc, pb.const(True), dst=acc)
    pb.op(ck.OP_OR, acc, pb.const(False), dst=acc)
    for pred, mode, eq in ((4321, ck.MODE_EQ, False), (777, ck.MODE_LT, True),
                           (9000, ck.MODE_GT, False),
                           ((1 << 20), ck.MODE_LT, False)):
        side = pb.load(pb.plane(ex_key, ex))
        bits, _ = bst.encode_pred(pred, depth)
        pb.bsi(side, first, depth, mode, bits, eq)
        pb.op(ck.OP_XOR, acc, side, dst=acc)
        pb.free(side)
    return pb.build(acc)


def max_err(x: torch.Tensor, y: torch.Tensor) -> int:
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def require_equal(what: str, x: torch.Tensor, y: torch.Tensor) -> int:
    """Max abs difference of a kernel result and its plain version; raises
    unless it is 0 (the outputs are integer words and counts)."""
    if x.shape != y.shape:
        raise AssertionError(f"{what}: shape {tuple(x.shape)} != "
                             f"{tuple(y.shape)}")
    err = max_err(x, y)
    if err != 0:
        raise AssertionError(f"{what}: kernel disagrees with plain version "
                             f"(max abs err {err})")
    return err


# -- phases -------------------------------------------------------------------

def wide_program(planes):
    """Every plane loaded before any is combined: as many live registers as
    planes (6 or more take the 12-register file)."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    pb = ck.ProgramBuilder(*planes[0].shape)
    regs = [pb.load(pb.plane(i, p)) for i, p in enumerate(planes)]
    acc = regs[0]
    for r in regs[1:]:
        pb.op(ck.OP_XOR, acc, r, dst=acc)
    return pb.build(acc)


def plan_eval_cases(S: int, depth: int, a, b, bsi, bsi32, flat) -> dict:
    """Every program shape the main path gives kernel A, at the slice's
    sizes, and every form of the kernel (register file 2, 4 or 12; 8, 4 or
    1 words a thread a step): name -> (program, want_words, want_counts)."""
    odd = bsi[:, :, 1:]   # W - 1 words at a 4-byte offset: the scalar path
    return {
        "and_count": (and_program(a, b), False, True),
        "bsi_gt_count": (bsi_gt_program(bsi, 5000), False, True),
        "between_count": (between_program(bsi, 1, 99), False, True),
        "between32_count": (between_program(bsi32, -12345, (1 << 32) - 7),
                            False, True),
        "flat_count_and": (and_program(*flat), False, True),
        "row_words": (word_program(a), True, False),
        "every_op": (every_op_program(a, b, bsi), True, True),
        "four_planes": (wide_program([a, b, bsi[:, 2], bsi[:, 3]]), True,
                        True),
        "wide_tree": (wide_program([bsi[:, j] for j in range(6)]), True,
                      True),
        "scalar_between": (between_program(odd, 1, 99), True, True),
        "scalar_wide_tree": (wide_program([odd[:, j] for j in range(6)]),
                             True, True),
    }


def kernel_parity(S: int, depth: int, R: int):
    """Phase 3: exact kernel-vs-plain parity at the slice's shapes."""
    from featurebase_tpu_torch.ops import bitwise as bw
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    W = 32768
    rng = np.random.default_rng(7)
    a, b = rand_words(rng, (S, W)), rand_words(rng, (S, W))
    bsi = rand_words(rng, (S, depth + 2, W))
    bsi32 = rand_words(rng, (16, 34, W))
    flat = (rand_words(rng, (1, 1 << 22)), rand_words(rng, (1, 1 << 22)))
    tile, filt = rand_words(rng, (S, R, W)), rand_words(rng, (S, W))
    cases = plan_eval_cases(S, depth, a, b, bsi, bsi32, flat)
    errs_a, errs_b = [], []
    for name, (prog, _, _) in cases.items():
        kw, kc = ck.plan_eval(prog, True, True)
        pw, pc = ck.plan_eval_plain(prog, True, True)
        errs_a.append(require_equal(f"plan_eval {name} words", kw, pw))
        errs_a.append(require_equal(f"plan_eval {name} counts", kc, pc))
    acc = torch.tensor([[12345]], dtype=torch.int32, device="cuda")
    errs_a.append(require_equal(
        "count_and with acc", bw.count_and(a, b, acc),
        ck.popcount_words(a & b).sum() + 12345))
    x, y = (t.reshape(-1) for t in flat)
    errs_a.append(require_equal(
        "count_and flat 2^22", bw.count_and(x, y),
        ck.popcount_words(x & y).sum()))
    odd = a.reshape(-1)[: 1000003]   # irregular size: the scalar path
    errs_a.append(require_equal(
        "count_and odd size", bw.count_and(odd, odd.flip(0)),
        ck.popcount_words(odd & odd.flip(0)).sum()))
    for s in (S, 1):
        for f in (None, filt[:s]):
            errs_b.append(require_equal(
                f"row_counts S={s} filter={f is not None}",
                ck.row_counts(tile[:s], f), ck.row_counts_plain(tile[:s], f)))
    errs_b += row_table_parity(rng)
    torch.cuda.synchronize()
    errs = {"plan_eval": max(errs_a), "row_counts": max(errs_b)}
    say("kernel_parity", ok=True, shapes={"S": S, "W": W, "R": R,
                                          "bsi_planes": depth + 2,
                                          "between32": [16, 34, W],
                                          "flat_words": 1 << 22},
        checks=[f"plan_eval {n} (words, counts)" for n in cases]
        + ["count_and + acc", "count_and flat 2^22",
           "count_and odd size (scalar path)",
           "row_counts S/1 x filtered/unfiltered",
           "row_counts_sharded: S = 1, 5, 32, 128 x W = 32768, 1001, 37 x "
           "no filter, filter words, filter rows (slot -1, shards without a "
           "tile or a filter row); 150 rows (a device table, three row "
           "tiles)"],
        instr_words={n: len(c[0].instrs) for n, c in cases.items()},
        plan_eval_forms=ck.plan_eval_config())
    return errs, dict(cases=cases, tile=tile, filt=filt, a=a, b=b)


def row_table_parity(rng) -> list:
    """Kernel B' over address tables against row_counts_sharded_plain:
    per-shard tiles of 3-11 rows, slots at random with -1 (an absent row),
    every seventh shard without a tile, and filters none, (S, W) words, or a
    row a shard with every fifth shard's None; at S = 1, 5, 32 and 128 and
    W = 32768, 1001 (the 4-byte path) and 37; then 150 rows of 3 shards (a
    table past the launch's parameters, three row tiles of the kernel)."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    errs = []
    for W in (32768, 1001, 37):
        for S in (1, 5, 32, 128):
            tiles, slots, rows = [], np.full((S, 9), -1), []
            for s in range(S):
                if s % 7 == 3:
                    tiles.append(None)
                else:
                    n = 3 + s % 9
                    tiles.append(rand_words(rng, (n, W)))
                    slots[s] = rng.integers(-1, n, 9)
                rows.append(None if s % 5 == 2 else rand_words(rng, (W,)))
            for name, f in (("none", None),
                            ("words", rand_words(rng, (S, W))),
                            ("rows", rows)):
                errs.append(require_equal(
                    f"row_counts_sharded W={W} S={S} filter={name}",
                    ck.row_counts_sharded(tiles, slots, f),
                    ck.row_counts_sharded_plain(tiles, slots, f)))
    big = rand_words(rng, (3, 150, 4096))
    errs.append(require_equal(
        "row_counts R=150", ck.row_counts(big, big[:, 0]),
        ck.row_counts_plain(big, big[:, 0])))
    return errs


def kernel_times(timer: Timer, inputs) -> dict:
    """Phase 4: kernel vs plain vs bound vs copy ceiling."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    big = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    big2 = torch.empty_like(big)
    copy_ms = timer(lambda: big2.copy_(big))
    copy_bps = 2 * big.numel() * 4 / (copy_ms / 1e3)
    say("copy_ceiling", bytes=2 * big.numel() * 4, ms=copy_ms,
        gb_per_s=copy_bps / 1e9)
    tile, filt = inputs["tile"], inputs["filt"]
    S, R, W = tile.shape
    out = {}
    def measure(fn, plain, nbytes, slow_plain=False):
        return dict(ms=timer(fn),
                    plain_ms=(slow_plain_ms if slow_plain else timer)(plain),
                    device_ms=kernel_device_ms(fn, timer.reps), bytes=nbytes,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    copy_ceiling_ms=nbytes / copy_bps * 1e3)

    for name, (prog, ww, wc) in inputs["cases"].items():
        s, w = prog.S, prog.W
        nbytes = (len(prog.planes) * s * w * 4 + (s * w * 4 if ww else 0)
                  + (s * 8 if wc else 0))
        r = out[f"plan_eval/{name}"] = measure(
            lambda: ck.plan_eval(prog, ww, wc),
            lambda: ck.plan_eval_plain(prog, ww, wc), nbytes)
        r.update(planes=len(prog.planes), shape=[s, w])
        kinds = [k for k in r["device_ms"] if k.startswith("plan_eval")]
        scalar = any("false" in k or "(bool)0" in k for k in kinds)
        if not kinds or scalar != name.startswith("scalar"):
            raise AssertionError(f"plan_eval {name}: the kernel ran in the "
                                 f"wrong form: {r['device_ms']}")
        if wc and "Memset" in r["device_ms"]:
            raise AssertionError(f"plan_eval {name}: a Memset runs beside the "
                                 "kernel; a Count must be one device "
                                 "operation")
    for name, f in (("row_counts/unfiltered", None),
                    ("row_counts/filtered", filt)):
        out[name] = measure(
            lambda: ck.row_counts(tile, f),
            lambda: ck.row_counts_plain(tile, f),
            (S * R * W + (0 if f is None else S * W)) * 4 + S * R * 8)
    # one shard (a Rows scan's S = 1 launch; the shape of every per-shard
    # launch before B' read the mirrors in place)
    one = tile[:1].contiguous()
    out[f"row_counts/s1_r{R}"] = measure(
        lambda: ck.row_counts(one), lambda: ck.row_counts_plain(one),
        R * W * 4 + R * 8)
    # MinRow/MaxRow and the per-shard GroupBys' level 0: one launch over
    # every shard's (R, W) mirror, beside the one-shard launches it replaces
    mirrors = [t.clone() for t in tile]
    slots = np.tile(np.arange(R), (S, 1))
    r = out[f"row_counts/mirrors_s{S}_r{R}"] = measure(
        lambda: ck.row_counts_sharded(mirrors, slots),
        lambda: ck.row_counts_sharded_plain(mirrors, slots),
        S * R * W * 4 + S * R * 8, slow_plain=True)
    r["one_shard_launches_ms"] = timer(
        lambda: [ck.row_counts(m[None]) for m in mirrors])
    for name in ("row_counts/filtered", f"row_counts/s1_r{R}",
                 f"row_counts/mirrors_s{S}_r{R}"):
        if "Memset" in out[name]["device_ms"]:
            raise AssertionError(f"{name}: a Memset runs beside kernel B'; "
                                 "its chunks must add up without one")
    out.update(bsi_times(measure, timer, inputs["bsi"]))
    for name, r in out.items():
        say("kernel_time", kernel=name, **r)
    return out, copy_bps


def bsi_times(measure, timer: Timer, group_filter) -> dict:
    """Kernels C' and D' (D' as a Min) at the main path's shapes: the
    stacked group at S = 128, D = 14; one shard (a shard's launch before
    the per-shard Sum and Min/Max read every mirror in one); two shards at
    depth 43 (the limits index's Percentile bisection, its Min and Max);
    and one launch over 128 shards' mirrors, beside the 128 one-shard
    launches it replaces."""
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    group, gfilt = group_filter
    gs, planes, gw = group.shape
    out = {}

    def both(key, g, f, nbytes_c, nbytes_d):
        out[f"bsi_sum_planes/{key}"] = measure(
            lambda: ck.bsi_sum_planes(g, f),
            lambda: bsiops.sum_planes_plain(g, f), nbytes_c)
        out[f"bsi_min_max/{key}"] = measure(
            lambda: ck.bsi_min_max(g, f, True),
            lambda: bsiops.min_max_parts_plain(g, f, True), nbytes_d)

    def nbytes(S, P, W):   # the group and the filter once; the outputs
        read = (P + 1) * S * W * 4
        return read + (2 * P - 3) * 8, read + S * 64
    both("d14", group, gfilt, *nbytes(gs, planes, gw))
    g1, f1 = group[:1].contiguous(), gfilt[:1].contiguous()
    both("s1_d14", g1, f1, *nbytes(1, planes, gw))
    rng = np.random.default_rng(17)
    g43, f43 = rand_words(rng, (2, 45, gw)), rand_words(rng, (2, gw))
    both("s2_d43", g43, f43, *nbytes(2, 45, gw))
    mirrors = [g.clone() for g in group]
    rows = [f.clone() for f in gfilt]
    nc, nd = nbytes(gs, planes, gw)
    r = out[f"bsi_sum_planes/mirrors_s{gs}_d14"] = measure(
        lambda: ck.bsi_sum_planes_sharded(mirrors, rows),
        lambda: ck.bsi_sum_planes_sharded_plain(mirrors, rows), nc,
        slow_plain=True)
    r["one_shard_launches_ms"] = timer(
        lambda: [ck.bsi_sum_planes(m[None], f[None])
                 for m, f in zip(mirrors, rows)])
    r = out[f"bsi_min_max/mirrors_s{gs}_d14"] = measure(
        lambda: ck.bsi_min_max_sharded(mirrors, rows, True),
        lambda: ck.bsi_min_max_sharded_plain(mirrors, rows, True), nd,
        slow_plain=True)
    r["one_shard_launches_ms"] = timer(
        lambda: [ck.bsi_min_max(m[None], f[None], True)
                 for m, f in zip(mirrors, rows)])
    for name, r in out.items():
        if "Memset" in r["device_ms"]:
            raise AssertionError(f"{name}: a Memset runs beside the kernel; "
                                 "a call must be one device operation")
    return out


# Builds of kernel A for the ablation: without its copies (the program
# runs on stale tiles), and without its program (the copies and a count of
# plane 0).
ABLATIONS = {"copy_only": ("-DFB_ABLATE_COMPUTE",),
             "compute_only": ("-DFB_ABLATE_COPY",)}


def ablation(inputs, reps: int) -> dict:
    """Phase 4b: each staged kernel-A case's device time under the ablation
    builds beside the kernel's own: where a launch's time goes.  (The
    scalar form has no copies to drop.)"""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    real, out = ck._lib, {}
    try:
        for name, flags in (("kernel", ()), *ABLATIONS.items()):
            ck._lib = lambda flags=flags: real(flags)
            for case, (prog, ww, wc) in inputs["cases"].items():
                if case.startswith("scalar"):
                    continue
                dev = kernel_device_ms(lambda: ck.plan_eval(prog, ww, wc),
                                       reps)
                out.setdefault(case, {})[name] = sum(
                    v for k, v in dev.items() if k.startswith("plan_eval"))
    finally:
        ck._lib = real
    say("ablation", device_ms=out)
    return out


# Builds of kernel B' for its load-path ablation: the row chunks staged in
# shared memory by TMA bulk copies, beside the default's 16-byte loads
ROW_ABLATION = ("-DFB_ROWS_STAGED",)
# and of kernel I' for its search's: the lift over all K thresholds, beside
# the default's bucket table
PCT_ABLATION = ("-DFB_PCT_BINARY",)


def row_ablation(inputs, reps: int) -> dict:
    """Phase 4c: kernel B' at the main path's shapes (stacked at S = 128,
    filtered and not; one shard; one launch over every shard's mirror),
    built with its row chunks staged by 1-D TMA bulk copies beside the
    default build's direct 16-byte loads: device time of each, in turns."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    tile, filt = inputs["tile"], inputs["filt"]
    S, R, _ = tile.shape
    one = tile[:1].contiguous()
    mirrors = [t.clone() for t in tile]
    slots = np.tile(np.arange(R), (S, 1))
    cases = {"filtered": lambda: ck.row_counts(tile, filt),
             "unfiltered": lambda: ck.row_counts(tile),
             f"s1_r{R}": lambda: ck.row_counts(one),
             f"mirrors_s{S}": lambda: ck.row_counts_sharded(mirrors, slots)}
    real, out = ck._lib, {}
    try:
        for name, flags in (("direct", ()), ("staged", ROW_ABLATION),
                            ("direct_again", ()), ("staged_again",
                                                   ROW_ABLATION)):
            ck._lib = lambda flags=flags: real(flags)
            for case, fn in cases.items():
                dev = kernel_device_ms(fn, reps)
                out.setdefault(case, {})[name] = sum(
                    v for k, v in dev.items() if k.startswith("row_counts"))
    finally:
        ck._lib = real
    say("row_ablation", device_ms=out)
    return out


def pct_ablation(inputs, reps: int) -> dict:
    """Phase 4f: kernel I' over the slice's values at a round of 129
    thresholds (the bisection's) and of 512, built with the lift over all
    K thresholds beside the default build's bucket table: device time of
    each, in turns."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.ops import decode
    group, vals, filt = inputs
    exists = group[:, 0]
    lo, hi = -(1 << 14), 1 << 14
    rng = np.random.default_rng(37)
    lists = {"round_129": sorted({lo, hi, *decode.pivot_tree(
                 lo, hi, decode.PERCENTILE_LEVELS)}),
             "k512": sorted(rng.integers(lo, hi, 512).tolist())}
    real, out = ck._decode_lib, {}
    try:
        for name, flags in (("buckets", ()), ("binary", PCT_ABLATION),
                            ("buckets_again", ()), ("binary_again",
                                                    PCT_ABLATION)):
            ck._decode_lib = lambda flags=flags: real(flags)
            for case, t in lists.items():
                dev = kernel_device_ms(
                    lambda t=t: ck.percentile_counts(vals, exists, filt, 0, t),
                    reps)
                out.setdefault(case, {})[name] = sum(
                    v for k, v in dev.items() if k.startswith("percentile"))
    finally:
        ck._decode_lib = real
    say("pct_ablation", device_ms=out)
    return out


def group_ablation(reps: int) -> dict:
    """Phase 4d: kernels E and F at the main path's one-launch shapes (128
    shards; E 8 x 4, F 8 x 4 groups at D = 14)
    under the ablation builds of csrc/group_kernels.cu beside its own:
    the copies alone, and the product on stale rows."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    S, W = 128, 32768
    mt = [gpu_words(gen, (8, W)) for _ in range(S)]
    rt_ = [gpu_words(gen, (4, W)) for _ in range(S)]
    bsi = [gpu_words(gen, (16, W)) for _ in range(S)]
    ms_, rs = np.tile(np.arange(8), (S, 1)), np.tile(np.arange(4), (S, 1))
    cases = {
        "pair_counts": lambda: ck.pair_counts_sharded(mt, ms_, rt_, rs),
        "bsi_sum_groups": lambda: ck.bsi_sum_groups_sharded(
            bsi, [(mt, ms_), (rt_, rs)])}
    real, out = ck._group_lib, {}
    try:
        for name, flags in (("kernel", ()), *ABLATIONS.items()):
            ck._group_lib = lambda flags=flags: real(flags)
            for case, fn in cases.items():
                dev = kernel_device_ms(fn, reps)
                out.setdefault(case, {})[name] = sum(
                    v for k, v in dev.items() if k.startswith(case))
    finally:
        ck._group_lib = real
    say("group_ablation", device_ms=out, shards=S)
    return out


# -- kernels C and D ----------------------------------------------------------

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(S, C) bool columns -> (S, C / 32) int32 words (column c at word
    c / 32, bit c % 32)."""
    S, C = bits.shape
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    w = (bits.view(S, C // 32, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def encode_group(mag: torch.Tensor, neg: torch.Tensor, ex: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """(S, depth + 2, C / 32) BSI group of the present (`ex`) columns with
    magnitudes `mag` and sign bits `neg` ((S, C) each); a set sign on a
    zero magnitude is a sign-set zero."""
    S, C = mag.shape
    group = torch.empty((S, depth + 2, C // 32), dtype=torch.int32,
                        device=mag.device)
    group[:, 0] = pack_bits(ex)
    group[:, 1] = pack_bits(ex & neg)
    for d in range(depth):
        group[:, 2 + d] = pack_bits(ex & (((mag >> d) & 1) == 1))
    return group


def bsi_cases(S: int) -> dict:
    """The groups kernels C and D are held on: name -> (group, filter).
    Random words at the slice's shape, and encoded values at depths 1, 14,
    31, 32 and 63 (the deepest the port's Field allows): ties across
    shards, sign-set zeros (a set sign on magnitude 0, 1% of columns at the
    wider depths), every column negative, empty and all-ones filters, an odd
    W (the scalar form) and S = 131 and 7 (no whole number of tiles per
    block)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rng = np.random.default_rng(11)

    def rand(shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def values(shards, W, depth, base_shards=None, neg_p=0.5):
        """(mag, neg, ex) of shards x 32 W columns; with base_shards, the
        first base_shards shards repeat (ties across shards)."""
        n = base_shards or shards
        C = 32 * W
        mag = torch.randint(0, 1 << min(depth, 62), (n, C), generator=gen,
                            device="cuda", dtype=torch.int64)
        if depth > 62:
            mag |= torch.randint(0, 2, (n, C), generator=gen, device="cuda",
                                 dtype=torch.int64) << 62
        mag = torch.where(rand((n, C)) < 0.01, 0, mag)
        neg, ex = rand((n, C)) < neg_p, rand((n, C)) < 0.6
        reps = -(-shards // n)
        return tuple(x.repeat(reps, 1)[:shards] for x in (mag, neg, ex))

    def filt(shards, W, kind="random"):
        if kind == "random":
            return rand_words(rng, (shards, W))
        return torch.full((shards, W), -1 if kind == "ones" else 0,
                          dtype=torch.int32, device="cuda")

    W, odd = 32768, 32767
    cases = {"random_d14": (rand_words(rng, (S, 16, W)), filt(S, W))}
    mag, neg, ex = values(S, W, 2, base_shards=2)   # magnitudes 0..3
    cases["ties_d14"] = (encode_group(mag, neg, ex, 14), filt(S, W))
    for depth in (1, 14, 31, 32, 63):
        cases[f"values_d{depth}"] = (
            encode_group(*values(16, W, depth), depth), filt(16, W))
    mag, neg, ex = values(16, W, 13, neg_p=1.0)
    cases["all_negative_d14"] = (encode_group(mag, neg, ex, 14),
                                 filt(16, W, "ones"))
    cases["empty_filter_d32"] = (encode_group(*values(16, W, 32), 32),
                                 filt(16, W, "zeros"))
    cases["ones_filter_d31"] = (encode_group(*values(16, W, 31), 31),
                                filt(16, W, "ones"))
    cases["odd_w_s131_d14"] = (rand_words(rng, (131, 16, odd)),
                               filt(131, odd))
    cases["odd_w_s7_d32"] = (encode_group(*values(7, odd, 32), 32),
                             filt(7, odd))
    return cases


def shard_mirrors(group: torch.Tensor, rng, absent_p: float = 0.1):
    """Per-shard inputs of the sharded kernels C' and D' from a stacked
    group: shard s a fragment-like tile of its planes in random row order
    with two spare rows of random words and a slot a plane, about
    `absent_p` of the magnitude and sign planes absent (slot -1, read as
    zeros); shard 1 without data (None) when S > 1."""
    S, P, W = group.shape
    groups = []
    for s in range(S):
        if s == 1:
            groups.append(None)
            continue
        order = torch.from_numpy(rng.permutation(P + 2)).cuda()
        tile = rand_words(rng, (P + 2, W))
        tile[order[:P]] = group[s]
        slots = order[:P].cpu().numpy().astype(np.int64)
        slots[1:][rng.random(P - 1) < absent_p] = -1
        groups.append((tile, slots))
    return groups


def bsi_sharded_cases(cases: dict, rng) -> dict:
    """The sharded forms' cases: name -> (groups, filter), the filter (S, W)
    words or a row a shard with every fifth shard's None.  From bsi_cases:
    S = 128 and 131 (an odd W), depths 1 to 63, sign-set zeros, ties and
    empty filters; and S = 1 at every depth, S = 2 at depth 43 and S = 7 at
    depth 63 with W = 1001 (the plain-staging form)."""
    out = {}
    for name, (group, f) in cases.items():
        groups = shard_mirrors(group, rng)
        rows = [None if s % 5 == 3 else f[s] for s in range(f.shape[0])]
        out[f"mirrors_{name}"] = (groups, f if "s131" in name else rows)
    for depth in (1, 14, 31, 32, 43, 63):
        g, f = rand_words(rng, (1, depth + 2, 32768)), \
            rand_words(rng, (1, 32768))
        out[f"mirrors_s1_d{depth}"] = (shard_mirrors(g, rng), [f[0]])
    g, f = rand_words(rng, (2, 45, 32768)), rand_words(rng, (2, 32768))
    out["mirrors_s2_d43"] = (shard_mirrors(g, rng, 0.0), f)
    g, f = rand_words(rng, (7, 65, 1001)), rand_words(rng, (7, 1001))
    out["mirrors_s7_d63_w1001"] = (shard_mirrors(g, rng), f)
    return out


def bsi_parity(S: int):
    """Phase 3b: kernels C' and D' against their plain versions on the
    card, exactly: the stacked forms on every case of bsi_cases and on
    strided views of one (the affine table at a vector and a scalar
    shape), the sharded forms on bsi_sharded_cases; D' as a Min and as a
    Max each time.  Returns the errors and the slice-shaped random case for
    timing."""
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    cases = bsi_cases(S)
    rng = np.random.default_rng(13)
    wide, wf = cases["values_d14"]
    cases["view_w32764_d14"] = (wide[:, :, 4:], wf[:, 4:])
    cases["view_w32767_d14"] = (wide[:, :, 1:], wf[:, 1:])
    errs_c, errs_d, shapes = [], [], {}
    for name, (group, f) in cases.items():
        errs_c.append(require_equal(f"bsi_sum_planes {name}",
                                    ck.bsi_sum_planes(group, f),
                                    bsiops.sum_planes_plain(group, f)))
        for is_min in (True, False):
            errs_d.append(require_equal(
                f"bsi_min_max {name} is_min={is_min}",
                ck.bsi_min_max(group, f, is_min),
                bsiops.min_max_parts_plain(group, f, is_min)))
        shapes[name] = list(group.shape)
    del cases["view_w32764_d14"], cases["view_w32767_d14"]
    for name, (groups, f) in bsi_sharded_cases(cases, rng).items():
        errs_c.append(require_equal(
            f"bsi_sum_planes {name}", ck.bsi_sum_planes_sharded(groups, f),
            ck.bsi_sum_planes_sharded_plain(groups, f)))
        for is_min in (True, False):
            errs_d.append(require_equal(
                f"bsi_min_max {name} is_min={is_min}",
                ck.bsi_min_max_sharded(groups, f, is_min),
                ck.bsi_min_max_sharded_plain(groups, f, is_min)))
        shapes[name] = [len(groups)]
    torch.cuda.synchronize()
    say("bsi_parity", ok=True, cases=shapes)
    timing = cases["random_d14"]
    del cases
    return {"bsi_sum_planes": max(errs_c), "bsi_min_max": max(errs_d)}, timing


# -- kernels E and F ----------------------------------------------------------

def gpu_words(gen: torch.Generator, shape) -> torch.Tensor:
    """Random int32 words made on the card (the parity cases are too large
    to make on the host in good time)."""
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                         dtype=torch.int32, device="cuda")


def sharded_operands(gen: torch.Generator, S: int, n: int, W: int,
                     absent: bool = True, offset: bool = False):
    """Per-shard (n_s, W) tiles and an (S, n) slot table over them, as a
    dimension's rows in the fragments' mirrors: each shard's tile holds its
    rows in a shuffled order among spare ones; with `absent`, shard 1 has no
    tile and about one row in five is missing (slot -1); with `offset`, each
    tile is a view one word into a wider one (the 4-byte path)."""
    tiles, slots = [], np.full((S, n), -1, dtype=np.int64)
    rng = np.random.default_rng(int(torch.randint(
        0, 1 << 30, (1,), generator=gen, device="cuda").item()))
    for s in range(S):
        if absent and s == 1:
            tiles.append(None)
            continue
        rows = n + 2
        t = gpu_words(gen, (rows, W + (1 if offset else 0)))
        tiles.append(t[:, 1:] if offset else t)
        slots[s] = rng.permutation(rows)[:n]
        if absent:
            slots[s, rng.random(n) < 0.2] = -1
    return tiles, slots


def group_parity() -> dict:
    """Phase 3c: kernels E and F against their plain versions on the card,
    exactly (the product on the tensor cores, mma.sync .b1).  Stacked
    operands (the thin wrappers): E at S = 1, 32 and 128 with F and R each
    1, 8 and 33, with and without a filter; F at depths 1, 14, 31, 32 and
    63 with G = 1, 8, 32 and 33 at S = 1 and 32; both at an odd W, on
    all-ones words, empty masks and sign-only columns.  Per-shard operands
    read in place (one launch over every shard): absent rows (slot -1), a
    shard without a tile, one to three dimensions (E: a middle one), 512
    groups, filters as (S, W) words, per-shard rows with one missing, and
    viewed one word into a wider row (the 4-byte path), and D = 1, 14, 31,
    32 and 63."""
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    W, odd = 32768, 32767
    errs_e, errs_f, cases = [], [], []

    def check(errs, name, got, want):
        errs.append(require_equal(name, got, want))
        cases.append(name)

    masks, rows = gpu_words(gen, (128, 33, W)), gpu_words(gen, (128, 33, W))
    filt = gpu_words(gen, (128, W))
    for S in (1, 32, 128):
        for F in (1, 8, 33):
            for R in (1, 4, 33):
                m, r = masks[:S, :F], rows[:S, :R]
                for fw in (None, filt[:S]):
                    check(errs_e, f"pair_counts S={S} F={F} R={R} "
                          f"filter={fw is not None}",
                          ck.pair_counts(m, r, fw),
                          ck.pair_counts_plain(m, r, fw))
    del masks, rows, filt
    ones = torch.full((4, 9, odd), -1, dtype=torch.int32, device="cuda")
    zero = torch.zeros_like(ones)
    rnd = gpu_words(gen, (4, 9, odd))
    for name, m, r, fw in (
            ("odd_w", rnd[:, :5], rnd[:, 4:], rnd[:, 0]),
            ("all_ones", ones[:, :5], ones[:, 4:], ones[:, 0]),
            ("empty_masks", zero[:, :5], rnd[:, 4:], None)):
        check(errs_e, f"pair_counts {name}",
              ck.pair_counts(m, r, fw), ck.pair_counts_plain(m, r, fw))
    for depth in (1, 14, 31, 32, 63):
        group = gpu_words(gen, (32, depth + 2, W))
        gm = gpu_words(gen, (32, 33, W))
        for S in (1, 32):
            for G in (1, 8, 32, 33):
                g, m = group[:S], gm[:S, :G]
                check(errs_f, f"bsi_sum_groups D={depth} S={S} G={G}",
                      ck.bsi_sum_groups(g, m), bsiops.sum_groups_plain(g, m))
        del group, gm
    sign_only = torch.zeros((4, 16, odd), dtype=torch.int32, device="cuda")
    sign_only[:, 1] = -1                            # every sign bit set
    sign_only[:, 0] = gpu_words(gen, (4, odd))      # exists on half
    for name, g, m in (
            ("odd_w", gpu_words(gen, (4, 16, odd)), rnd[:, :9]),
            ("all_ones", ones[:, :8].repeat(1, 2, 1), ones[:, :9]),
            ("empty_masks", gpu_words(gen, (4, 16, odd)), zero[:, :9]),
            ("sign_only", sign_only, rnd[:, :9])):
        check(errs_f, f"bsi_sum_groups {name}",
              ck.bsi_sum_groups(g, m), bsiops.sum_groups_plain(g, m))
    del ones, zero, rnd, sign_only

    # per-shard operands, read in place
    S = 5
    wide = gpu_words(gen, (S, W + 1))
    filters = {"none": None, "words": gpu_words(gen, (S, W)),
               "rows": [gpu_words(gen, (W,)) if s != 3 else None
                        for s in range(S)],
               "odd_offset": wide[:, 1:]}
    for (F, M, R), offset in (((8, 0, 4), False), ((33, 0, 5), False),
                              ((4, 3, 4), False), ((8, 0, 4), True),
                              ((65, 0, 40), False)):
        mt, ms = sharded_operands(gen, S, F, W, offset=offset)
        rt_, rs = sharded_operands(gen, S, R, W)
        mid = sharded_operands(gen, S, M, W) if M else None
        for fname, fw in filters.items():
            check(errs_e, f"pair_counts_sharded F={F} M={M} R={R} "
                  f"offset={offset} filter={fname}",
                  ck.pair_counts_sharded(mt, ms, rt_, rs, fw, mid),
                  ck.pair_counts_sharded_plain(mt, ms, rt_, rs, fw, mid))
    for depth, sizes, fname in ((1, (8,), "words"), (14, (8, 4), "none"),
                                (14, (8, 4), "odd_offset"),
                                (31, (3, 4, 2), "rows"),
                                (32, (5, 3), "words"),
                                (63, (8, 4), "odd_offset"),
                                (14, (8, 8, 8), "none")):
        dims = [sharded_operands(gen, S, n, W) for n in sizes]
        bsi = [gpu_words(gen, (depth + 2, W)) if s != 2 else None
               for s in range(S)]
        fw = filters[fname]
        check(errs_f, f"bsi_sum_groups_sharded D={depth} dims={sizes} "
              f"filter={fname}",
              ck.bsi_sum_groups_sharded(bsi, dims, fw),
              ck.bsi_sum_groups_sharded_plain(bsi, dims, fw))
    torch.cuda.synchronize()
    say("group_parity", ok=True, cases=len(cases),
        pair_counts={"S": [1, 32, 128], "F": [1, 8, 33], "R": [1, 4, 33],
                     "filter": [False, True]},
        bsi_sum_groups={"D": [1, 14, 31, 32, 63], "G": [1, 8, 32, 33],
                        "S": [1, 32]},
        other_cases=[c for c in cases if not c.endswith(("True", "False"))
                     and "G=" not in c])
    return {"pair_counts": max(errs_e), "bsi_sum_groups": max(errs_f)}


def rate_loop(launch, reps: int) -> float:
    """Median ms of `launch` with CUDA events, after one warm-up."""
    launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def popc_rate(reps: int) -> dict:
    """The card's 32-bit popcount rate: the popcount-only loop of
    csrc/group_kernels.cu (8 independent chains a thread, 8 blocks of 256
    threads an SM), CUDA events, median of `reps`; beside the published
    rate, 16 a clock per SM at the card's maximum SM clock."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    lib = ck._group_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    out = torch.empty(blocks, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.fb_popc_rate(out.data_ptr(), blocks, iters, stream)
        if rc != 0:
            raise RuntimeError(f"popc_rate launch failed: CUDA error {rc}")
    ms = rate_loop(run, reps)
    measured = 8 * iters * 256 * blocks / (ms / 1e3)
    published = POPC_PER_CLOCK_PER_SM * sms * max_sm_clock_hz()
    r = dict(measured_per_s=measured, published_per_s=published,
             measured_over_published=measured / published, ms=ms, sms=sms,
             max_sm_clock_mhz=max_sm_clock_hz() / 1e6)
    say("popc_rate", **r)
    return r


def tc_rate(reps: int, popc: dict) -> dict:
    """The tensor cores' rate for the AND-popcount product, beside the
    popcount unit's: mma.sync m16n8k256 .b1 .and.popc (32,768 bit products
    an instruction) and int8 mma.sync m16n8k32 (4,096 products, one a bit
    once the bits are unpacked to bytes), each eight independent chains a
    warp on 4 blocks of 256 threads an SM, CUDA events, median of `reps`;
    and whether ptxas takes the warpgroup .b1 form (csrc/wgmma_b1_probe.cu,
    built in the build phase).  In bit products a second."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    lib = ck._group_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 4, 2048
    out = torch.empty(blocks, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, b1, per in (("b1_mma_sync", 1, 32768), ("int8_mma_sync", 0,
                                                      4096)):
        def run(b1=b1):
            rc = lib.fb_tc_rate(out.data_ptr(), blocks, iters, b1, stream)
            if rc != 0:
                raise RuntimeError(f"tc_rate launch failed: CUDA error {rc}")
        ms = rate_loop(run, reps)
        rates[name] = 8 * iters * 8 * blocks * per / (ms / 1e3)
    rates["popc"] = popc["measured_per_s"] * 32
    r = dict(bit_products_per_s=rates,
             b1_over_popc=rates["b1_mma_sync"] / rates["popc"],
             int8_over_popc=rates["int8_mma_sync"] / rates["popc"],
             int8_published_per_s=1.979e15 / 2,
             wgmma_b1_taken=WGMMA_PROBE.get("taken"),
             wgmma_b1_log=WGMMA_PROBE.get("log", "")[-400:])
    say("tc_rate", **r)
    return r


WGMMA_PROBE: dict = {}


def group_times(timer: Timer, rates: dict, reps: int) -> dict:
    """Phase 4c: kernels E and F beside the plain versions and their bound:
    the larger of bytes (each input row read once, the counts written once)
    at 3.35 TB/s and the AND-popcounts (G x C x S x W words) at the tensor
    cores' measured 1-bit rate; beside it the popcount unit's time for the
    same popcounts.  The main path's one-launch shapes at 128 shards (E: 8
    masks x 4 rows; F: 8 x 4 groups at D = 14, 470 MB), read in place from
    per-shard tiles, beside S launches of one shard each (the per-shard
    loop this launch replaces); and the stacked shapes of the earlier
    slices (E at S = 1 and 32 filtered; F at S = 1 and 32)."""
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    W, out = 32768, {}

    def measure(name, fn, plain, nbytes, words, G, C, per_shard=None):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bit_products = words * G * C * 32
        o_ms = bit_products / rates["b1_mma_sync"] * 1e3
        r = dict(bytes=nbytes, popcounts=words * G * C, bytes_ms=b_ms,
                 ops_ms=o_ms, popc_unit_ms=bit_products / rates["popc"] * 1e3,
                 bound_ms=max(b_ms, o_ms),
                 bound_by="bytes" if b_ms >= o_ms else "operations",
                 route="mma", ms=timer(fn),
                 device_ms=kernel_device_ms(fn, reps),
                 plain_ms=(timer if nbytes < 128 << 20 else
                           slow_plain_ms)(plain))
        if per_shard is not None:
            r["per_shard_loop_ms"] = timer(per_shard)
        out[name] = r
        say("kernel_time", kernel=name, **r)

    S = 128
    mt = [gpu_words(gen, (8, W)) for _ in range(S)]
    rt_ = [gpu_words(gen, (4, W)) for _ in range(S)]
    ms_, rs = np.tile(np.arange(8), (S, 1)), np.tile(np.arange(4), (S, 1))
    measure(f"pair_counts/sharded_s{S}_f8_r4",
            lambda: ck.pair_counts_sharded(mt, ms_, rt_, rs),
            lambda: ck.pair_counts_sharded_plain(mt, ms_, rt_, rs),
            12 * S * W * 4 + 32 * 8, S * W, 8, 4,
            lambda: [ck.pair_counts_sharded(mt[s:s + 1], ms_[s:s + 1],
                                            rt_[s:s + 1], rs[s:s + 1])
                     for s in range(S)])
    bsi = [gpu_words(gen, (16, W)) for _ in range(S)]
    dims = [(mt, ms_), (rt_, rs)]
    measure(f"bsi_sum_groups/sharded_s{S}_g32_d14",
            lambda: ck.bsi_sum_groups_sharded(bsi, dims),
            lambda: ck.bsi_sum_groups_sharded_plain(bsi, dims),
            28 * S * W * 4 + 32 * 29 * 8, S * W, 32, 29,
            lambda: [ck.bsi_sum_groups_sharded(
                bsi[s:s + 1], [(mt[s:s + 1], ms_[s:s + 1]),
                               (rt_[s:s + 1], rs[s:s + 1])])
                for s in range(S)])
    del mt, rt_, bsi, dims
    for S, F, R, filtered in ((1, 8, 4, False), (32, 8, 4, True)):
        m, r = gpu_words(gen, (S, F, W)), gpu_words(gen, (S, R, W))
        fw = gpu_words(gen, (S, W)) if filtered else None
        measure(f"pair_counts/s{S}_f{F}_r{R}"
                + ("_filtered" if filtered else ""),
                lambda: ck.pair_counts(m, r, fw),
                lambda: ck.pair_counts_plain(m, r, fw),
                (F + R + (1 if filtered else 0)) * S * W * 4 + F * R * 8,
                S * W, F, R)
    for S, G, D in ((1, 32, 14), (32, 8, 14)):
        g, m = gpu_words(gen, (S, D + 2, W)), gpu_words(gen, (S, G, W))
        measure(f"bsi_sum_groups/s{S}_g{G}_d{D}",
                lambda: ck.bsi_sum_groups(g, m),
                lambda: bsiops.sum_groups_plain(g, m),
                (D + 2 + G) * S * W * 4 + G * (2 * D + 1) * 8, S * W, G,
                2 * D + 1)
    return out


# -- kernel H -----------------------------------------------------------------

def moments_cases(S: int) -> dict:
    """The inputs kernel H is held on: name -> (groups, filter), one group
    for Var and two for Corr.  Random words (planes not under exists) at
    S = 1 and 3 for Var at depths 1, 5, 14 and 31 and Corr at (1, 1),
    (5, 3), (14, 12) and (31, 31), each with a plane all zero; at the
    slice's S for Var at depths 14 and 31 and Corr at (14, 12) and
    (31, 31); encoded values with signs and sign-set zeros at depth 14;
    all-ones and empty filters; an odd W (the 4-byte form) at S = 7; and a
    view one word into a wider group (the 4-byte form at W = 32767)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    W, cases = 32768, {}

    def grp(S_, D, W_=W):
        g = gpu_words(gen, (S_, D + 2, W_))
        g[:, 2 + D // 2] = 0   # an absent plane
        return g
    for S_ in (1, 3):
        for D in (1, 5, 14, 31):
            cases[f"var_s{S_}_d{D}"] = ([grp(S_, D)], gpu_words(gen, (S_, W)))
        for Dx, Dy in ((1, 1), (5, 3), (14, 12), (31, 31)):
            cases[f"corr_s{S_}_d{Dx}x{Dy}"] = (
                [grp(S_, Dx), grp(S_, Dy)], gpu_words(gen, (S_, W)))
    cases[f"var_s{S}_d14"] = ([grp(S, 14)], gpu_words(gen, (S, W)))
    cases[f"var_s{S}_d31"] = ([grp(S, 31)], gpu_words(gen, (S, W)))
    cases[f"corr_s{S}_d14x12"] = ([grp(S, 14), grp(S, 12)],
                                  gpu_words(gen, (S, W)))
    cases[f"corr_s{S}_d31x31"] = ([grp(S, 31), grp(S, 31)],
                                  gpu_words(gen, (S, W)))
    C = 32 * W

    def values(S_, depth):
        mag = torch.randint(0, 1 << depth, (S_, C), generator=gen,
                            device="cuda", dtype=torch.int64)
        rand = torch.rand((3, S_, C), generator=gen, device="cuda")
        mag = torch.where(rand[0] < 0.01, 0, mag)
        return encode_group(mag, rand[1] < 0.4, rand[2] < 0.6, depth)
    vx, vy = values(16, 14), values(16, 12)
    ones = torch.full((16, W), -1, dtype=torch.int32, device="cuda")
    cases["var_values_d14_ones"] = ([vx], ones)
    cases["corr_values_d14x12_ones"] = ([vx, vy], ones)
    cases["corr_values_d14x12_empty"] = ([vx, vy], torch.zeros_like(ones))
    cases["var_odd_w_s7_d9"] = ([grp(7, 9, 1001)], gpu_words(gen, (7, 1001)))
    cases["corr_odd_w_s7_d9x4"] = ([grp(7, 9, 1001), grp(7, 4, 1001)],
                                   gpu_words(gen, (7, 1001)))
    wide = grp(5, 14, W + 1)
    cases["var_view_s5_d14"] = ([wide[:, :, 1:]],
                                gpu_words(gen, (5, W + 1))[:, 1:])
    return cases


def moments_parity(S: int) -> dict:
    """Phase 3e: kernel H (var_moments, corr_moments) against its plain
    versions on the card, exactly, on every case of moments_cases: stacked
    (the table pointing into the stacked groups), and over per-shard
    mirrors (var_moments_sharded, corr_moments_sharded: shuffled planes,
    absent planes, a shard without data; the filter as words, as rows with
    every fifth shard's None, and absent)."""
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(23)
    errs = {"var_moments": 0, "corr_moments": 0}
    checked = []

    def same(name, got, want, key):
        for i, (a, b) in enumerate(zip(got, want)):
            errs[key] = max(errs[key], require_equal(f"{name}[{i}]", a, b))
        checked.append(name)
    for name, (groups, f) in moments_cases(S).items():
        key = "var_moments" if len(groups) == 1 else "corr_moments"
        plain = bsiops.var_moments_plain if key == "var_moments" else \
            bsiops.corr_moments_plain
        same(name, getattr(ck, key)(*groups, f), plain(*groups, f), key)
        torch.cuda.synchronize()
        if "view" in name or groups[0].shape[0] > 32 and "d31" in name:
            continue
        mirrors = [shard_mirrors(g, rng) for g in groups]
        dense = [torch.stack([
            torch.zeros_like(g[0]) if m is None else
            torch.where(torch.as_tensor(m[1] >= 0, device="cuda")[:, None],
                        m[0][torch.as_tensor(np.maximum(m[1], 0),
                                             device="cuda")], 0)
            for m in ms]) for g, ms in zip(groups, mirrors)]
        rows = [None if s % 5 == 3 else f[s] for s in range(f.shape[0])]
        row_dense = torch.stack([torch.zeros_like(f[0]) if r is None else r
                                 for r in rows])
        sharded = getattr(ck, f"{key}_sharded")
        for fname, filt, fd in (("words", f, f), ("rows", rows, row_dense),
                                ("none", None, torch.full_like(f, -1))):
            same(f"{name}/mirrors_{fname}", sharded(*mirrors, filt),
                 plain(*dense, fd), key)
        torch.cuda.synchronize()
    say("moments_parity", checks=len(checked), cases=checked, errors=errs)
    return errs


def moments_plan_of(groups, f) -> dict:
    """The planner's view of a stacked launch of kernel H' over `groups`
    under the filter words `f` (ops/cuda_kernels.py moments_plan)."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    S, _, W = groups[0].shape
    table = np.concatenate([ck._filter_addrs(f, S, W)]
                           + [ck._stacked_addrs(g) for g in groups], axis=1)
    depths = [g.shape[1] - 2 for g in groups]
    return ck.moments_plan(ck._moments_spec(table, W, depths, True), W)


def moments_plans(S: int) -> dict:
    """Phase 4d': one launch of each of the six forms of kernel H' at S shards
    (Var at depths 14, 20 and 31; Corr at 14 x 12, 1 x 31 and 31 x 31),
    as the planner lays it out: form, chunk words, ring stages, resident
    blocks an SM (the occupancy API), grid, shared bytes and staged
    bytes."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    W, out = 32768, {}
    ptr = 1 << 20   # any 16-byte aligned addresses: nothing is launched
    for depths in ((14,), (20,), (31,), (14, 12), (1, 31), (31, 31)):
        P = 1 + sum(d + 2 for d in depths)
        table = np.full((S, P), ptr, dtype=np.uint64)
        out["x".join(map(str, depths))] = ck.moments_plan(
            ck._moments_spec(table, W, list(depths), True), W)
    say("moments_plans", shards=S, plans=out)
    return out


def moments_times(timer: Timer, rates: dict, reps: int, S: int) -> dict:
    """Phase 4d: kernel H' at the main path's shapes beside its plain
    version and its bound, the larger of bytes (the groups and the filter
    read once, the (R, C) product written once) at 3.35 TB/s and the bit
    products (R x C a column: the basis' product) at the tensor cores'
    measured 1-bit rate: Var at depth 14 (the bench table's v) and Corr at
    depths 14 and 12 (v and u) over S stacked shards.  Each launch's plan
    (resident blocks an SM, staged bytes) is printed beside its time, and
    Corr's staged bytes must be its 31 rows a shard, each once."""
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    W, out = 32768, {}
    f = gpu_words(gen, (S, W))
    gx, gy = gpu_words(gen, (S, 16, W)), gpu_words(gen, (S, 14, W))
    for name, groups, fn, plain, rows in (
            (f"var_moments/s{S}_d14", [gx], lambda: ck.var_moments(gx, f),
             lambda: bsiops.var_moments_plain(gx, f), 17),
            (f"corr_moments/s{S}_d14x12", [gx, gy],
             lambda: ck.corr_moments(gx, gy, f),
             lambda: bsiops.corr_moments_plain(gx, gy, f), 31)):
        plan = moments_plan_of(groups, f)
        if plan["staged_bytes"] != rows * S * W * 4:
            raise AssertionError(f"{name} stages {plan['staged_bytes']} "
                                 f"bytes, not {rows} rows a shard once")
        cells = plan["R"] * plan["C"]
        nbytes = rows * S * W * 4 + cells * 8
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bit_products = cells * S * W * 32
        o_ms = bit_products / rates["b1_mma_sync"] * 1e3
        r = dict(bytes=nbytes, bit_products=bit_products, bytes_ms=b_ms,
                 ops_ms=o_ms, popc_unit_ms=bit_products / rates["popc"] * 1e3,
                 bound_ms=max(b_ms, o_ms),
                 bound_by="bytes" if b_ms >= o_ms else "operations",
                 ms=timer(fn), device_ms=kernel_device_ms(fn, reps),
                 plain_ms=slow_plain_ms(plain), plan=plan)
        out[name] = r
        say("kernel_time", kernel=name, **r)
    return out


def moments_ablation(reps: int, S: int) -> dict:
    """Phase 4e: kernel H' at the main path's shapes over S stacked shards
    (Var at depth 14, Corr at 14 x 12) under the ablation builds of
    csrc/moments_kernels.cu beside its own, in turns (kernel, copies
    alone, product on stale rows, kernel again)."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    W = 32768
    f = gpu_words(gen, (S, W))
    gx, gy = gpu_words(gen, (S, 16, W)), gpu_words(gen, (S, 14, W))
    cases = {f"var_moments/s{S}_d14": lambda: ck.var_moments(gx, f),
             f"corr_moments/s{S}_d14x12": lambda: ck.corr_moments(gx, gy, f)}
    real, out = ck._moments_lib, {}
    try:
        for name, flags in (("kernel", ()), *ABLATIONS.items(),
                            ("kernel_again", ())):
            ck._moments_lib = lambda flags=flags: real(flags)
            for case, fn in cases.items():
                dev = kernel_device_ms(fn, reps)
                out.setdefault(case, {})[name] = sum(
                    v for k, v in dev.items() if k.startswith("moments"))
    finally:
        ck._moments_lib = real
    say("moments_ablation", device_ms=out, shards=S)
    return out


# -- kernels G'', G''' and I' ------------------------------------------------

def decode_cases(S: int) -> dict:
    """The groups kernels G'' and G''' are held on: name -> (S, D + 2, W)
    group.  Encoded values at depths 1, 14 and 31 (every column signed at
    random, 40% absent, 1% sign-set zeros), random words at the slice's
    shape, and a view one word into a wider group (W - 1 words, the ragged
    last item of the kernel, 4-byte copies)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    W = 32768

    def values(shards, depth):
        C = 32 * W
        mag = torch.randint(0, 1 << depth, (shards, C), generator=gen,
                            device="cuda", dtype=torch.int64)
        mag = torch.where(torch.rand((shards, C), generator=gen,
                                     device="cuda") < 0.01, 0, mag)
        neg = torch.rand((shards, C), generator=gen, device="cuda") < 0.5
        ex = torch.rand((shards, C), generator=gen, device="cuda") < 0.6
        return encode_group(mag, neg, ex, depth)

    cases = {f"values_d{d}": values(16, d) for d in (1, 14, 31)}
    cases["random_d14"] = gpu_words(gen, (S, 16, W))
    cases["offset_d14"] = gpu_words(gen, (8, 16, W))[:, :, 1:]
    return cases


def decode_sharded_cases(cases: dict, rng) -> dict:
    """The sharded forms' cases (kernels G'' and G'''): name -> per-shard
    groups.  From decode_cases, through shard_mirrors (each shard's planes
    in random rows of a tile, about a tenth of the magnitude and sign
    planes absent, shard 1 without data): the slice-shaped random words at
    S = 128, the encoded values at depths 1, 14 and 31 over 16 shards, and
    per-shard views one word into a wider group (4-byte copies); and random
    words at S = 131 (depth 31) and 7 (depth 1) with W = 1001, and at
    S = 1."""
    out = {f"mirrors_s{g.shape[0]}_{name}": shard_mirrors(g, rng)
           for name, g in cases.items() if name != "offset_d14"}
    out["views_s8_d14_w32767"] = list(cases["offset_d14"])
    for S, D, W in ((131, 31, 1001), (7, 1, 1001), (1, 14, 32768)):
        out[f"mirrors_s{S}_d{D}_w{W}"] = shard_mirrors(
            rand_words(rng, (S, D + 2, W)), rng)
    return out


def percentile_reduction(vals, exists, filt, base: int, pivots) -> list:
    """The plain torch-reduction form of a Percentile round, as the JAX
    program counts it (bsi.py:571): for each pivot, the present values below
    it and above it, one reduction each."""
    from featurebase_tpu_torch.ops import decode
    present = decode.expand_bits(exists & filt).bool()
    x = vals + base
    return [(int((present & (x < p)).sum()), int((present & (x > p)).sum()))
            for p in pivots]


def decode_parity(S: int) -> tuple:
    """Phase 3d: kernels G'', G''' and I' against their plain versions on
    the card, exactly.  G'' on every decode_cases group (stacked: the affine
    table) and G''' at N = 1, 37 and 65,536 columns of one shard of each;
    both over the address tables of decode_sharded_cases (planes out of
    order, absent planes, a shard without data, S = 1, 7, 8, 16, 128 and
    131, W = 32768, 32767 and 1001, depths 1, 14 and 31), G''' with N = 0,
    1, 37 and 65,536 columns a shard in turn; I
    over the decode of the slice-shaped group and of the depth-31 values,
    under random and empty filters and exists words viewed one word into a
    wider row, with threshold lists: none (the prep pass), sorted random
    ones with duplicates, ones holding the min and the max, a full round of
    the bisection (129) and one of 512, and a base that shifts values; then
    the Percentile bisection driven by I against the same driven by the
    plain counts, and its probes against percentile_reduction."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.ops import decode
    cases = decode_cases(S)
    rng = np.random.default_rng(29)
    errs = {"bsi_decode": [0], "bsi_decode_gather": [0],
            "percentile_counts": [0]}
    checks = []

    def check(kernel, name, got, want):
        got, want = ([got] if isinstance(got, torch.Tensor) else got,
                     [want] if isinstance(want, torch.Tensor) else want)
        for g, w in zip(got, want):
            errs[kernel].append(require_equal(f"{kernel} {name}", g, w))
        checks.append(f"{kernel} {name}")

    decoded = {}
    for name, group in cases.items():
        decoded[name] = ck.bsi_decode(group)
        check("bsi_decode", name, decoded[name],
              decode.decode_values_plain(group))
        shard = group[0]
        C = 32 * shard.shape[1]
        for n in (1, 37, 1 << 16):
            cols = rng.choice(C, n, replace=False)
            check("bsi_decode_gather", f"{name} N={n}",
                  ck.bsi_decode_gather(shard, cols),
                  decode.decode_gather_plain(shard,
                                             torch.from_numpy(cols).cuda()))
    # the sharded forms over address tables: N = 0, 1, 37 and 65,536
    # columns a shard in turn (all of a shard's columns where it has
    # fewer), 65,536 at S = 1
    sharded = []
    for name, groups in decode_sharded_cases(cases, rng).items():
        sharded.append(f"{name} S={len(groups)}")
        check("bsi_decode", name, ck.bsi_decode_sharded(groups),
              ck.bsi_decode_sharded_plain(groups))
        C = 32 * next(g[0] if isinstance(g, tuple) else g
                      for g in groups if g is not None).shape[1]
        cols = [rng.choice(C, min((0, 1, 37, 1 << 16)[s % 4]
                                  if len(groups) > 1 else 1 << 16, C),
                           replace=False) for s in range(len(groups))]
        check("bsi_decode_gather", name,
              ck.bsi_decode_gather_sharded(groups, cols),
              ck.bsi_decode_gather_sharded_plain(groups, cols))
    W, nf = 32768, max(S, 16)
    wide = rand_words(rng, (nf, W + 1))
    filters = {"random": rand_words(rng, (nf, W)),
               "empty": torch.zeros((nf, W), dtype=torch.int32,
                                    device="cuda"),
               "offset": wide[:, 1:]}
    for vname, gname in (("random_d14", "random_d14"),
                         ("values_d31", "values_d31")):
        vals, group = decoded[vname], cases[gname]
        s = vals.shape[0]
        exists = group[:, 0]
        x = vals[decode.expand_bits(exists).bool()]
        lo, hi = int(x.min()), int(x.max())
        picks = np.sort(rng.choice(x.cpu().numpy(), 40))
        lists = {
            "prep": [],
            "duplicates": sorted(picks.tolist() + picks[::3].tolist()),
            "min_max": [lo, int(np.median(picks)), hi],
            "round_129": sorted(rng.integers(lo, hi, 129).tolist()),
            "full_512": sorted(rng.integers(lo, hi, 512).tolist()),
        }
        for fname, fw in filters.items():
            for lname, t in lists.items():
                for base in (0, -7):
                    check("percentile_counts",
                          f"{vname} filter={fname} {lname} base={base}",
                          ck.percentile_counts(vals, exists, fw[:s], base, t),
                          decode.percentile_counts_plain(vals, exists,
                                                         fw[:s], base, t))
    # each form of kernel I' (the prep pass; K <= 4 in registers; wider
    # rounds through the bucket table) at K = 0, 1, 2, 129 and 512: random
    # thresholds, duplicated ones, every value below them, every value
    # above them; bases that shift value + base and that wrap it in int32
    vals, exists = decoded["random_d14"][:16], cases["random_d14"][:16, 0]
    fw = filters["random"][:16]
    x = vals[decode.expand_bits(exists & fw).bool()]
    lo, hi = int(x.min()), int(x.max())
    for K in (0, 1, 2, 129, 512):
        kinds = {"random": sorted(rng.integers(lo, hi, K).tolist()),
                 "duplicates": sorted(rng.choice(
                     rng.integers(lo, hi, max(K // 3, 1)), K).tolist()),
                 "all_below": sorted(rng.integers(
                     hi + 1, (1 << 31) - 1, K).tolist()),
                 "all_above": sorted(rng.integers(
                     -(1 << 31), lo, K).tolist())} if K else {"prep": []}
        for kind, t in kinds.items():
            for base in (0, -7, (1 << 31) - 5):
                # at base 2^31 - 5 most values wrap: the kind names where
                # they lie at base 0
                check("percentile_counts", f"K={K} {kind} base={base}",
                      ck.percentile_counts(vals, exists, fw, base, t),
                      decode.percentile_counts_plain(vals, exists, fw,
                                                     base, t))
    vals, exists = decoded["random_d14"], cases["random_d14"][:, 0]
    fw = filters["random"][:S]
    for nth in (0, 0.5, 20.2, 50, 99.9, 100):
        check("percentile_counts", f"bisection nth={nth}",
              torch.tensor(decode.percentile(vals, exists, fw, 0, nth)),
              torch.tensor(decode.percentile(
                  vals, exists, fw, 0, nth,
                  counts=decode.percentile_counts_plain)))
    probes = decode.pivot_tree(-8000, 8000, 5)
    t = sorted(set(probes))
    h = ck.percentile_counts(vals, exists, fw, 0, t).cpu().tolist()
    total = sum(h[:2 * len(t) + 1])
    below, mine = 0, {}
    for k, p in enumerate(t):
        below += h[2 * k]
        mine[p] = (below, total - below - h[2 * k + 1])
        below += h[2 * k + 1]
    check("percentile_counts", "31 pivots against the reduction form",
          torch.tensor([mine[p] for p in probes]),
          torch.tensor(percentile_reduction(vals, exists, fw, 0, probes)))
    torch.cuda.synchronize()
    say("decode_parity", ok=True, checks=len(checks),
        cases={n: list(g.shape) for n, g in cases.items()},
        gather_n=[0, 1, 37, 1 << 16], filters=list(filters),
        sharded=sharded,
        threshold_lists=["prep", "duplicates", "min_max", "round_129",
                         "full_512"],
        widths=[0, 1, 2, 129, 512],
        kinds=["random", "duplicates", "all_below", "all_above"],
        bases=[0, -7, (1 << 31) - 5])
    return {k: max(v) for k, v in errs.items()}, (cases["random_d14"],
                                                  decoded["random_d14"],
                                                  filters["random"][:S])


def decode_times(timer: Timer, inputs, reps: int) -> dict:
    """Phase 4e: kernels G'', G''' and I' beside their plain versions and
    their bytes bounds, at the main path's shapes: G'' over the
    slice-shaped group (S = 128, D = 14: D + 1 planes read, 4 bytes a
    column written), stacked and over 128 shards' mirrors beside the 128
    one-shard launches that route made before; G''' at N = 1,000 and
    65,536 columns of one shard, and at 1,000 columns a shard over 128
    shards' mirrors beside 128 one-shard launches; I' over the slice's values,
    exists and filter words with no thresholds (the prep pass) and with a
    round's 129, beside the torch-reduction form's time for the 31 pivots of
    a JAX round (62 reductions)."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.ops import decode
    group, vals, filt = inputs
    S, P, W = group.shape
    C, D = 32 * W, P - 2
    out = {}

    def measure(name, fn, plain, nbytes, slow_plain=False):
        r = dict(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes", ms=timer(fn),
                 device_ms=kernel_device_ms(fn, reps),
                 plain_ms=(slow_plain_ms if slow_plain else timer)(plain))
        out[name] = r
        say("kernel_time", kernel=name, **r)
        return r

    decode_bytes = (D + 1) * S * W * 4 + S * C * 4
    measure(f"bsi_decode/s{S}_d{D}", lambda: ck.bsi_decode(group),
            lambda: decode.decode_values_plain(group), decode_bytes,
            slow_plain=True)
    mirrors = [g.clone() for g in group]
    r = measure(f"bsi_decode/mirrors_s{S}_d{D}",
                lambda: ck.bsi_decode_sharded(mirrors),
                lambda: ck.bsi_decode_sharded_plain(mirrors), decode_bytes,
                slow_plain=True)
    r["one_shard_launches_ms"] = timer(
        lambda: [ck.bsi_decode(m[None]) for m in mirrors])
    say("one_shard_launches", kernel=f"bsi_decode/mirrors_s{S}_d{D}",
        one_launch_ms=r["ms"], ms=r["one_shard_launches_ms"])
    rng = np.random.default_rng(31)
    shard = group[0]

    def gather_bytes(per_shard):   # ids in, D + 2 words a word, 8 bytes out
        n = sum(c.size for c in per_shard)
        words = sum(np.unique(c >> 5).size for c in per_shard)
        return n * 4 + words * P * 4 + n * 8
    for n in (1000, 1 << 16):
        cols = np.sort(rng.choice(C, n, replace=False))
        measure(f"bsi_decode_gather/n{n}_d{D}",
                lambda: ck.bsi_decode_gather(shard, cols),
                lambda: decode.decode_gather_plain(
                    shard, torch.from_numpy(cols).cuda()),
                gather_bytes([cols]))
    per = [np.sort(rng.choice(C, 1000, replace=False)) for _ in range(S)]
    r = measure(f"bsi_decode_gather/mirrors_s{S}_n1000_d{D}",
                lambda: ck.bsi_decode_gather_sharded(mirrors, per),
                lambda: ck.bsi_decode_gather_sharded_plain(mirrors, per),
                gather_bytes(per), slow_plain=True)
    r["one_shard_launches_ms"] = timer(
        lambda: [ck.bsi_decode_gather(m, c) for m, c in zip(mirrors, per)])
    say("one_shard_launches",
        kernel=f"bsi_decode_gather/mirrors_s{S}_n1000_d{D}",
        one_launch_ms=r["ms"], ms=r["one_shard_launches_ms"])
    del mirrors
    exists = group[:, 0]
    lo, hi = -(1 << 14), 1 << 14
    x = vals[decode.expand_bits(exists & filt).bool()]
    mn, mx = int(x.min()), int(x.max())
    del x
    for name, t in (("prep", []),
                    # nth 0 and 100: the min and the max, every value
                    # between or at them
                    ("k2", [mn, mx]),
                    ("round_129", sorted({lo, hi, *decode.pivot_tree(
                        lo, hi, decode.PERCENTILE_LEVELS)}))):
        r = measure(f"percentile_counts/s{S}_{name}",
                    lambda t=t: ck.percentile_counts(vals, exists, filt, 0, t),
                    lambda t=t: decode.percentile_counts_plain(
                        vals, exists, filt, 0, t),
                    S * C * 4 + 2 * S * W * 4 + (2 * len(t) + 3) * 8
                    + len(t) * 4, slow_plain=True)
        r["thresholds"] = len(t)
    pivots = decode.pivot_tree(lo, hi, 5)
    red = Timer(3)(lambda: percentile_reduction(vals, exists, filt, 0, pivots))
    out[f"percentile_counts/s{S}_round_129"]["reduction_31_pivots_ms"] = red
    say("percentile_reduction", pivots=len(pivots), ms=red,
        kernel_round_ms=out[f"percentile_counts/s{S}_round_129"]["ms"])
    return out


def build_table(n_shards: int, seed: int = 0):
    """The slice's table through the port's import API, plus the generating
    arrays for the oracle."""
    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.index import Holder
    rng = np.random.default_rng(seed)
    cols = np.concatenate([
        s * SHARD_WIDTH + np.sort(rng.choice(SHARD_WIDTH, RECORDS_PER_SHARD,
                                             replace=False))
        for s in range(n_shards)]).astype(np.int64)
    n = cols.size
    f_rows = rng.integers(0, 8, size=n)
    g_rows = rng.integers(0, 4, size=n)
    vals = rng.integers(-1000, 10000, size=n)
    # u, for Corr: a third of v plus noise, on nine records in ten
    u_has = rng.random(n) < 0.9
    u = np.clip(vals // 3 + rng.integers(-600, 600, size=n), -500, 4000)
    holder = Holder()
    idx = holder.create_index("bench")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", FieldOptions(type="int", min=-1000, max=10000))
    idx.create_field("u", FieldOptions(type="int", min=-500, max=4000))
    u_s = []

    def import_u():
        t0 = time.perf_counter()
        idx.field("u").import_values(cols[u_has], u[u_has])
        u_s.append(time.perf_counter() - t0)
    # each field's import on a thread of its own, as concurrent imports
    # through the API run (the fields share no fragment)
    jobs = [lambda: idx.field("f").import_bits(f_rows, cols),
            lambda: idx.field("g").import_bits(g_rows, cols),
            lambda: idx.field("v").import_values(cols, vals), import_u,
            lambda: idx.mark_exists(cols)]
    run_threads(jobs)
    # the small indexes draw from their own seeds, so their data (and the
    # launches of their queries) do not depend on --shards
    limits = limits_index(holder, np.random.default_rng(seed + 1))
    keyed_index(holder, np.random.default_rng(seed + 2))
    return holder, dict(f=f_rows, g=g_rows, v=vals, u=u, u_has=u_has,
                        cols=cols, limits=limits, u_import_s=u_s[0])


def run_threads(jobs) -> None:
    """Each job on a thread of its own, joined; the first error raised."""
    import threading
    errors = []

    def guard(job):
        try:
            job()
        except BaseException as e:   # noqa: BLE001 — raised below
            errors.append(e)
    threads = [threading.Thread(target=guard, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def limits_index(holder, rng) -> dict:
    """The "limits" index of LIMIT_QUERIES; returns its w and a values and
    their columns."""
    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    from featurebase_tpu_torch.model.field import FieldOptions
    n = 3000
    cols = np.sort(rng.choice(2 * SHARD_WIDTH, n, replace=False))
    idx = holder.create_index("limits")
    idx.create_field("f")
    idx.create_field("g")
    idx.field("f").import_bits(rng.integers(0, 60, n), cols)
    half = rng.random(n) < 0.5
    idx.field("g").import_bits(rng.integers(0, 3, int(half.sum())),
                               cols[half])
    ab = {}
    for name in "ab":
        idx.create_field(name, FieldOptions(type="int", min=0, max=1 << 30))
        ab[name] = rng.integers(0, 1 << 30, n, endpoint=True)
        idx.field(name).import_values(cols, ab[name])
    top = (1 << 43) - 1
    idx.create_field("w", FieldOptions(type="int", min=-top, max=top))
    w = rng.integers(0, 500, n) * (1 << 34) - 5
    idx.field("w").import_values(cols, w)
    idx.mark_exists(cols)
    return dict(w=w, a=ab["a"], cols=cols)


def keyed_index(holder, rng) -> None:
    """The "keyed" index of KEYED_QUERIES: 40 records with string keys, a
    keyed set field kf, a set field s and an int field n."""
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.index import IndexOptions
    idx = holder.create_index("keyed", IndexOptions(keys=True))
    recs = [f"rec-{i}" for i in range(40)]
    ids = idx.translate_store.create_keys(recs)
    cols = np.array(sorted(ids[r] for r in recs), dtype=np.int64)
    idx.create_field("kf", FieldOptions(keys=True))
    keys = ["alpha", "beta", "gamma"]
    kid = idx.row_translation("kf").create_keys(keys)
    idx.field("kf").import_bits(
        np.array([kid[keys[i]] for i in rng.integers(0, 3, cols.size)]), cols)
    idx.create_field("s")
    idx.field("s").import_bits(rng.integers(0, 5, cols.size), cols)
    idx.create_field("n", FieldOptions(type="int", min=0, max=1000))
    idx.field("n").import_values(cols, rng.integers(0, 1000, cols.size))
    idx.mark_exists(cols)


def index_of(q: str):
    """(index name, query) of a QUERIES entry."""
    for name in ("limits", "keyed"):
        if q.startswith(f"{name}:"):
            return name, q[len(name) + 1:]
    return "bench", q[len(PER_SHARD):] if q.startswith(PER_SHARD) else q


def execute(executor, q: str, run=None):
    """The result of a QUERIES entry, through `executor` or through
    `run(index, pql)` over it (the API's query); a PER_SHARD one runs with
    both GroupBy caps of `executor` at 0, so that it takes the per-shard
    level-wise loop."""
    run = run or (lambda index, pql: executor.execute(index, pql)[0])
    if not q.startswith(PER_SHARD):
        return run(*index_of(q))
    executor.GROUPBY_ONESHOT_MAX_COUNTS = 0
    executor.GROUPBY_ONESHOT_MAX_MASK_BYTES = 0
    try:
        return run(*index_of(q))
    finally:
        del executor.GROUPBY_ONESHOT_MAX_COUNTS
        del executor.GROUPBY_ONESHOT_MAX_MASK_BYTES


def digest(x) -> str:
    return hashlib.sha1(json.dumps(x).encode()).hexdigest()


def canon(result):
    """Comparable form of a query result; a bitmap as its column count and
    a digest of its sorted columns (UnionRows(Rows(g)) holds every record)
    and its keys; Distinct's values, Sort's columns and values and
    Extract's table as digests beside their sizes."""
    from featurebase_tpu_torch.executor.results import (ExtractedTable,
                                                        GroupCount, PairField,
                                                        PairsField, ValCount)
    from featurebase_tpu_torch.model.row import Row, SignedRow
    if isinstance(result, Row):
        cols = result.columns()
        return ("row", (int(cols.size),
                        hashlib.sha1(cols.tobytes()).hexdigest(),
                        result.keys))
    if isinstance(result, SignedRow):
        vals = [int(v) for v in result.values()]
        return ("signed", (len(vals), digest(vals)))
    if isinstance(result, dict):     # Sort
        return ("sort", (len(result["columns"]),
                         digest([result["columns"], result["values"]])))
    if isinstance(result, ExtractedTable):
        return ("table", (len(result.col_ids), digest(
            [[[f.name, f.type] for f in result.fields], result.col_ids,
             result.field_values])))
    if result is None or isinstance(result, bool):
        return ("value", result)
    if isinstance(result, float):   # Var, Corr
        return ("float", result)
    if isinstance(result, list):   # Rows' ids or GroupBy's groups
        return ("list", [(tuple(fr.row_id for fr in x.group), x.count, x.agg)
                         if isinstance(x, GroupCount) else int(x)
                         for x in result])
    if isinstance(result, PairsField):
        return ("pairs", [(p.id, p.count) for p in result.pairs])
    if isinstance(result, ValCount):
        return ("valcount", (result.val, result.count))
    if isinstance(result, PairField):
        return ("pair", (result.pair.id, result.pair.count))
    return ("value", int(result))


SMALL_RANGE = 1 << 24   # integers over a range this wide count by histogram


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """np.unique of integers, by a histogram (one pass) when their range is
    narrow, as the tables' values are."""
    if x.size == 0 or int(x.max()) - int(x.min()) > SMALL_RANGE:
        return np.unique(x)
    lo = int(x.min())
    return np.flatnonzero(np.bincount(x.astype(np.int64) - lo)) + lo


def first_records(idx: np.ndarray, key: np.ndarray, cols: np.ndarray,
                  k: int, desc: bool = False) -> np.ndarray:
    """The k records of `idx` first in the order of (key, column), key
    descending with `desc`: the head of np.lexsort over the records,
    sorting only those whose key can be among the first k."""
    kv = key[idx].astype(np.int64) * (-1 if desc else 1)
    if idx.size > k:
        keep = kv <= np.partition(kv, k - 1)[k - 1]
        idx, kv = idx[keep], kv[keep]
    return idx[np.lexsort((cols[idx], kv))][:k]


def oracle_percentile(x: np.ndarray, nth) -> tuple:
    """Percentile of the based values `x` by the port's bisection
    (ops/decode.py percentile) over counts taken with numpy instead of
    kernel I: ((value, count), rounds of counts).  Its answer checks kernel
    I's counts; its rounds are the launches of kernel I a query makes.  The
    counts below a threshold come from a cumulative histogram of `x` (a
    sorted copy when its range is wide)."""
    from featurebase_tpu_torch.ops import decode
    x = x.astype(np.int64)
    calls = []
    if x.size and int(x.max()) - int(x.min()) <= SMALL_RANGE:
        lo = int(x.min())
        cum = np.concatenate([[0], np.cumsum(np.bincount(x - lo))])

        def below(t):   # values < t
            return cum[np.clip(t - lo, 0, cum.size - 1)]
    else:
        xs = np.sort(x)

        def below(t):
            return np.searchsorted(xs, t, side="left")

    def counts(vals, exists, filt, base, t):
        calls.append(len(t))
        t = np.asarray(t, dtype=np.int64)
        lo_t, hi_t = below(t), below(t + 1)
        bins = np.zeros(2 * t.size + 1, dtype=np.int64)
        bins[1::2] = hi_t - lo_t
        bins[0::2] = np.diff(np.concatenate([[0], lo_t, [x.size]])) - \
            np.concatenate([[0], hi_t - lo_t])
        ext = [int(x.min()), int(x.max())] if x.size else \
            [(1 << 31) - 1, -(1 << 31)]
        return torch.tensor(bins.tolist() + ext)
    val, cnt = decode.percentile(None, None, None, 0, nth, counts=counts)
    return (val, cnt), len(calls)


def decode_oracles(gen, col5: int, desc: np.ndarray) -> tuple:
    """numpy oracles of the decode family's queries over the bench table
    (keys as in QUERIES, placeholders included), and the launches of
    kernel I that a pass of the mix makes (oracle_percentile's rounds)."""
    f, g, v, cols = gen["f"], gen["g"], gen["v"], gen["cols"]

    def signed(vals):
        vals = [int(x) for x in sorted_unique(vals)]
        return ("signed", (len(vals), digest(vals)))

    def row(ids):
        ids = sorted_unique(np.asarray(ids)).astype(np.uint64)
        return ("row", (int(ids.size), hashlib.sha1(ids.tobytes()).hexdigest(),
                        None))

    def sort(order):
        return ("sort", (len(order), digest([[int(c) for c in cols[order]],
                                             [int(x) for x in v[order]]])))
    asc_f1 = first_records(np.flatnonzero(f == 1), v, cols, 10)
    d_f = sorted_unique(f[g == 2])
    asc_g1 = first_records(np.flatnonzero(g == 1), v, cols, 10)
    at5 = np.flatnonzero(cols == col5)[0]
    ext = np.flatnonzero(f == 1)[:1000]
    at42 = np.flatnonzero(v == 42)
    oracle = {
        "Distinct(field=v)": signed(v),
        "Distinct(Row(f=1), field=g)": row(g[f == 1]),
        "Count(Distinct(field=v))": ("value", int(sorted_unique(v).size)),
        "Count(Intersect(Row(f=1), Distinct(Row(g=2), field=f)))":
            ("value", int(((f == 1) & np.isin(cols, d_f)).sum())),
        "GroupBy(Rows(g), aggregate=Count(Distinct(field=v)))": (
            "list", [((r,), int((g == r).sum()),
                      int(sorted_unique(v[g == r]).size))
                     for r in range(4) if (g == r).any()]),
        "Sort(Row(f=1), field=v, limit=10)": sort(asc_f1[:10]),
        "Sort(All(), field=v, sort-desc=true, limit=5, offset=3)":
            sort(desc[3:8]),
        "Sort(All(), field=v, sort-desc=true, limit=5, after={after})":
            sort(desc[8:13]),
        "Extract(Limit(Row(f=1), limit=1000), Rows(f), Rows(g), Rows(v))": (
            "table", (int(ext.size), digest(
                [[["f", "[]id"], ["g", "[]id"], ["v", "int64"]],
                 [int(c) for c in cols[ext]],
                 [[[int(x)] for x in f[ext]], [[int(x)] for x in g[ext]],
                  [int(x) for x in v[ext]]]]))),
        "IncludesColumn(Row(f=1), column={col5})": ("value", bool(f[at5] == 1)),
        "FieldValue(field=v, column={col5})": ("valcount", (int(v[at5]), 1)),
        # every record has an f bit: the union is Row(g=1)
        "Distinct(Union(Row(g=1), Row(f=null)), field=v)": signed(v[g == 1]),
        "Sort(Union(Row(g=1), Row(f=null)), field=v, limit=10)":
            sort(asc_g1[:10]),
        "Extract(Row(v == 42), Rows(v), Rows(g))": (
            "table", (int(at42.size), digest(
                [[["v", "int64"], ["g", "[]id"]],
                 [int(c) for c in cols[at42]],
                 [[42] * int(at42.size), [[int(x)] for x in g[at42]]]]))),
    }
    rounds = 0
    for q, x in (("Percentile(field=v, nth=50)", v),
                 ("Percentile(field=v, nth=99.9, filter=Row(f=1))", v[f == 1]),
                 ("Percentile(field=v, nth=0)", v),
                 ("Percentile(field=v, nth=100)", v)):
        nth = float(q.split("nth=")[1].split(",")[0].rstrip(")"))
        answer, n = oracle_percentile(x, nth)
        oracle[q] = ("valcount", answer)
        rounds += n
    return oracle, rounds


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel in an nvcc
    -Xptxas -v log, by demangled-enough name (entry symbol)."""
    import re
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            out[fn] = {}
        elif fn is None:
            continue
        elif "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[fn].update(stack_bytes=nums[0], spill_stores=nums[1],
                           spill_loads=nums[2])
        elif "Used" in ln and "registers" in ln:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 ln).group(1))
    named = {}
    for sym, r in out.items():
        m = re.search(r"\d+([a-z_]+_kernel)(I.*?E)?Ev", sym)
        named[f"{m.group(1)}{m.group(2) or ''}" if m else sym] = r
    return named


def sass_loads(source: str) -> dict:
    """16-byte global loads (LDG.E.128) in the SASS of each kernel of a built
    source, by kernel symbol, from cuobjdump."""
    from featurebase_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path(source)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    loads, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            loads[fn] = 0
        elif fn is not None and "LDG.E.128" in ln:
            loads[fn] += 1
    return loads


def tune_sass_check() -> dict:
    """Every tuning kernel at every (T, V) keeps at least the 2 x V 16-byte
    loads of its main loop: a load whose word were never used would be
    dropped by the compiler, and the ceiling would not be one."""
    from featurebase_tpu_torch.ops import tune_kernels as tk
    loads = sass_loads(tk.SOURCE)
    out = {}
    for name in tk.KERNELS:
        for t, v in tk.SHAPES:
            sym = f"{name}_kernelILi{t}ELi{v}EE"
            got = [n for fn, n in loads.items() if sym in fn]
            if len(got) != 1 or got[0] < 2 * v:
                raise AssertionError(f"{name} {t}x{v}: LDG.E.128 counts "
                                     f"{got}, want one kernel with >= {2 * v}")
            out[f"{name}/{t}x{v}"] = got[0]
    say("tune_sass", ldg_e_128=out)
    return out


def tune_parity(cases: dict) -> dict:
    """Phase 6: each tuning kernel at every launch shape against its plain
    version, with a nonzero and a wrapping acc, on each case's two streams:
    the harness's 256 MB, the slice's (S, W) words, an odd size (the < 4
    words after the last 16-byte load) and a size under one block step."""
    from featurebase_tpu_torch.ops import tune_kernels as tk
    accs = (12345, (1 << 31) - 5)   # the second wraps past 2^31
    errs = {}
    for name, kernel in tk.KERNELS.items():
        err = 0
        for case, (x, y) in cases.items():
            for acc_v in accs:
                acc = torch.tensor([[acc_v]], dtype=torch.int32,
                                   device="cuda")
                want = tk.PLAIN[name](x, y, acc)
                for t, v in tk.SHAPES:
                    err = max(err, require_equal(
                        f"{name} {t}x{v} {case} acc={acc_v}",
                        kernel(x, y, acc, threads=t, vec=v), want))
        errs[name] = err
    torch.cuda.synchronize()
    say("tune_parity", ok=True, shapes=[f"{t}x{v}" for t, v in tk.SHAPES],
        sizes={c: int(x.numel()) for c, (x, _) in cases.items()},
        accs=list(accs))
    return errs


def tune_phase(timer: Timer, big, small, copy_bps: float, and_time: dict):
    """Phase 7: the tuning harness's default list on `big` (its 256 MB
    streams), then each tuning kernel at its best shape timed on `big` and
    on `small`, the slice's (S, W) words, beside plan_eval's AND."""
    from featurebase_tpu_torch.ops import tune_kernels as tk
    from featurebase_tpu_torch.tools import tune_count_kernel as harness
    tk.reset_launches()
    lines = [harness.measure(v, "cuda", big) for v in harness.DEFAULT]
    launches = tk.launches()
    for ln in lines:
        say("tune_variant", **ln, copy_ceiling_gb_per_s=copy_bps / 1e9)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "tuning harness")
    by_name = {ln["variant"]: ln for ln in lines}
    say("read_ceilings", copy_gb_per_s=copy_bps / 1e9,
        two_stream_read_gb_per_s=by_name["ceiling_dma"]["gb_per_s"],
        launches=launches)
    # each kernel at its best shape in the list, timed at the slice's size
    best = {}
    for ln in lines:
        k = ln["kernel"]
        if k in tk.KERNELS and (k not in best
                                or ln["gb_per_s"] > best[k]["gb_per_s"]):
            best[k] = ln
    acc = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    times = {"harness": {}, "slice": {}}
    for size, (x, y) in (("harness", big), ("slice", small)):
        nbytes = 2 * x.numel() * 4 + 8   # both streams and acc in, one out
        for name, ln in best.items():
            kernel, t, v = tk.KERNELS[name], ln["threads"], ln["vec"]
            fn = (lambda kernel=kernel, t=t, v=v, x=x, y=y:
                  kernel(x, y, acc, threads=t, vec=v))
            plain = (lambda name=name, x=x, y=y: tk.PLAIN[name](x, y, acc))
            times[size][name] = r = dict(
                shape=f"{t}x{v}", words=x.numel(), ms=timer(fn),
                plain_ms=timer(plain),
                device_ms=kernel_device_ms(fn, timer.reps), bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                copy_ceiling_ms=nbytes / copy_bps * 1e3,
                harness_gb_per_s=ln["gb_per_s"])
            say("kernel_time", kernel=f"{name}/{t}x{v}/{size}", **r)
    at_slice = times["slice"]
    partials = ("tune_direct_partial", "tune_csa_partial")
    read_ceiling = by_name["ceiling_dma"]["gb_per_s"] * 1e9
    say("tune_vs_plan_eval", words=small[0].numel(),
        plan_eval_and_ms=and_time["ms"],
        plan_eval_and_device_ms=and_time["device_ms"],
        csa_scalar_ms=at_slice["tune_csa_scalar"]["ms"],
        best_partial=min(partials, key=lambda k: at_slice[k]["ms"]),
        partial_ms=min(at_slice[k]["ms"] for k in partials))
    return launches, times["harness"], read_ceiling


def runs_for(first_ms: float, reps: int) -> int:
    """The runs of a latency p50 whose first run took `first_ms`: `reps`
    below 20 ms, half as many to 200 ms and 3 past it (the host decodes
    and the float64 moments, whose spread is small beside their
    length)."""
    if first_ms < 20:
        return reps
    return max(reps // 2, 1) if first_ms < 200 else 3


def mix_of(gen, n_shards: int) -> tuple:
    """(the QUERIES of an n_shards table, with a record of shard 5 for
    {col5} and the Sort cursor for {after}; col5; the first 13 records by v
    descending, then column; after).  The entries over shards 0-63 need 64
    shards."""
    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    cols = gen["cols"]
    col5 = int(cols[cols // SHARD_WIDTH == min(5, n_shards - 1)][0])
    # the second page of Sort(All(), field=v, sort-desc=true, limit=5,
    # offset=3) starts after its last record
    desc = first_records(np.arange(cols.size), gen["v"], cols, 13,
                         desc=True)
    after = f"[{int(gen['v'][desc[7]])}, {int(cols[desc[7]])}]"
    queries = [q.replace("{col5}", str(col5)).replace("{after}", after)
               for q in QUERIES if "shards=" not in q or n_shards > 63]
    return queries, col5, desc, after


def api_alone(n_shards: int, reps: int) -> None:
    """The api phase by itself (--only api): the table, unwritten, then
    api_phase."""
    import shutil
    holder, gen = build_table(n_shards)
    durable = api_phase(holder, WriteModel(gen), mix_of(gen, n_shards)[0],
                        reps)
    shutil.rmtree(durable["scratch"], ignore_errors=True)


CPU_WORKER_THREADS = 6   # torch threads of the CPU answers' worker


def cpu_executor_answers(cpu, queries, rank_cache) -> dict:
    """{query: (canon answer of the CPU executor `cpu`, seconds)}."""
    out = {}
    for q in queries:
        rank_cache.clear()   # TopN then counts on the plain path
        t0 = time.perf_counter()
        out[q] = (canon(execute(cpu, q)), time.perf_counter() - t0)
    return out


def gen_digest(gen) -> str:
    """A digest of the arrays a table was generated from."""
    h = hashlib.sha1()
    for k in ("cols", "f", "g", "v", "u", "u_has"):
        h.update(np.ascontiguousarray(gen[k]).view(np.uint8))
    return h.hexdigest()


def reference_answers(gen, n_shards: int, cpu, rank_cache) -> dict:
    """What slice_phase holds the card's answers to: numpy's exact oracles
    of the mix (mix_oracles, and exact_moments for kernel H''s Var and
    Corr) and the Percentile's rounds, numpy's moments within a tolerance
    (moment_oracles), and the CPU executor `cpu`'s answer to every entry
    of the mix no exact oracle holds (cpu_executor_answers)."""
    queries, col5, desc, after = mix_of(gen, n_shards)
    t0 = time.perf_counter()
    oracle, rounds = mix_oracles(gen, col5, desc)
    oracle.update(exact_moments(gen))
    moments = moment_oracles(gen)
    oracles_s = time.perf_counter() - t0
    exact = exact_queries(oracle, col5, after)
    return dict(oracle=oracle, rounds=rounds, moments=moments,
                oracles_s=oracles_s, cpu=cpu_executor_answers(
                    cpu, [q for q in queries if q not in exact], rank_cache))


def cpu_answers(n_shards: int, path: str) -> None:
    """The worker process of CPUWorker (chip_smoke.py --cpu-answers PATH):
    the table of build_table(n_shards) built afresh, then its
    reference_answers, pickled to PATH with the table's gen_digest and the
    seconds of the build.  It touches no CUDA device."""
    import pickle

    from featurebase_tpu_torch.executor.executor import Executor
    torch.set_num_threads(CPU_WORKER_THREADS)
    t0 = time.perf_counter()
    holder, gen = build_table(n_shards)
    build_s = time.perf_counter() - t0
    ref = reference_answers(gen, n_shards, Executor(holder, device="cpu"),
                            holder.index("bench").field("f")._topn_cache)
    with open(path + ".tmp", "wb") as fh:
        pickle.dump((gen_digest(gen), dict(ref, build_s=build_s)), fh)
    os.replace(path + ".tmp", path)


class CPUWorker:
    """numpy's oracles and the CPU executor's answers to the mix
    (reference_answers), computed by a worker process (cpu_answers) over
    its own copy of the table, on the host's cores while this process
    drives the card: it starts before the kernels' builds, and stops while
    the kernels are timed (stopped())."""

    def __init__(self, n_shards: int):
        import tempfile
        self.stopped_s = 0.0
        self.dir = tempfile.mkdtemp(prefix="chip-smoke-cpu-")
        self.path = os.path.join(self.dir, "answers.pickle")
        self.log = open(os.path.join(self.dir, "worker.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shards",
             str(n_shards), "--records-per-shard", str(RECORDS_PER_SHARD),
             "--cpu-answers", self.path],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=self.log, stderr=subprocess.STDOUT)

    @contextmanager
    def stopped(self):
        """The worker stopped (SIGSTOP) for the block and continued after,
        so that what the block times runs on a host without it."""
        running = self.proc.poll() is None
        if running:
            os.kill(self.proc.pid, signal.SIGSTOP)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if running and self.proc.poll() is None:
                os.kill(self.proc.pid, signal.SIGCONT)
            self.stopped_s += time.perf_counter() - t0

    def expect(self, gen) -> None:
        """The digest of this process's table (gen_digest), which result()
        holds the worker's to, taken on a thread (hashlib gives up the
        GIL over large buffers) while this process goes on."""
        import threading
        self.digest: dict = {}
        self.digest_thread = threading.Thread(
            target=lambda: self.digest.update(value=gen_digest(gen)))
        self.digest_thread.start()

    def result(self) -> dict:
        """The worker's answers, once its table's digest equals expect()'s."""
        import pickle
        t0 = time.perf_counter()
        try:
            code = self.proc.wait(timeout=1800)
        except subprocess.TimeoutExpired:
            self.close()
            raise AssertionError("the CPU answers' worker ran past 1800 s")
        say("cpu_worker", worker_s=time.perf_counter() - self.t0,
            waited_s=time.perf_counter() - t0, stopped_s=self.stopped_s,
            exit_code=code)
        if code != 0 or not os.path.exists(self.path):
            with open(self.log.name) as fh:
                raise AssertionError(f"the CPU answers' worker failed "
                                     f"(exit {code}):\n{fh.read()[-3000:]}")
        with open(self.path, "rb") as fh:
            digest, ref = pickle.load(fh)
        self.digest_thread.join()
        if digest != self.digest["value"]:
            raise AssertionError("the CPU answers' worker built another "
                                 "table")
        say("cpu_worker_parts", build_s=ref["build_s"],
            oracles_s=ref["oracles_s"],
            cpu_executor_s=sum(t for _, t in ref["cpu"].values()))
        return ref

    def close(self) -> None:
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def slice_phase(n_shards: int, reps: int, cpu_worker=None) -> dict:
    """Phase 5: the main path at full size, through Executor(holder);
    `cpu_worker` (CPUWorker), when given, holds the CPU executor's answers
    to the mix."""
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.model.row import Row
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.storage import residency
    t0 = time.perf_counter()
    holder, gen = build_table(n_shards)
    build_s = time.perf_counter() - t0
    if cpu_worker is not None:
        cpu_worker.expect(gen)
    idx = holder.index("bench")
    lap("table")
    say("table", shards=n_shards, records=int(gen["f"].size),
        bit_depth=idx.field("v").bit_depth,
        u_bit_depth=idx.field("u").bit_depth, build_s=build_s,
        u_import_s=gen["u_import_s"])
    queries, col5, desc, after = mix_of(gen, n_shards)
    decode_queries = [q.replace("{col5}", str(col5)).replace("{after}", after)
                      for q in DECODE_QUERIES]
    rank_cache = idx.field("f")._topn_cache

    def run(executor, q):
        rank_cache.clear()   # TopN then counts on the kernel path
        return canon(execute(executor, q))

    gpu = Executor(holder)
    ck.reset_launches()
    t0 = time.perf_counter()
    answers = {q: run(gpu, q) for q in queries}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ck.launches()
    resident = residency.residency().stats()
    vals_cache = {k[2]: v[1].numel() * 4 for k, v in
                  gpu.plan_executor._leaf_cache.items() if k[0] == "vals"}
    say("main_path", first_pass_s=first_s, launches=launches,
        residency=resident, stacked_vals_bytes=vals_cache)
    lap("main_path")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "main path")
    # numpy's oracles, and the CPU executor's answer to every entry no
    # exact oracle holds: from the worker process (cpu_answers), which
    # built the same table and computed them while this one drove the
    # card, or here without it
    ref = cpu_worker.result() if cpu_worker is not None else \
        reference_answers(gen, n_shards, Executor(holder, device="cpu"),
                          rank_cache)
    oracle, rounds, moments = ref["oracle"], ref["rounds"], ref["moments"]
    want = pass_launches(n_shards, rounds)
    if len(queries) == len(QUERIES) and launches != want:
        raise AssertionError(f"launches in one pass of the mix {launches} "
                             f"!= {want}")
    for q, want in oracle.items():
        q = q.replace("{col5}", str(col5)).replace("{after}", after)
        if q in answers and answers[q] != want:
            raise AssertionError(f"{q}: engine {answers[q]!r:.300} != "
                                 f"oracle {want!r:.300}")
    # every answer that numpy does not hold exactly (the float moments
    # included) against a CPU executor's on the same table; an answer
    # equal to its exact numpy oracle is not computed a third time
    unheld = [q for q in queries
              if q not in exact_queries(oracle, col5, after)]
    cpu_answers_of = ref["cpu"]
    if sorted(cpu_answers_of) != sorted(unheld):
        raise AssertionError("the CPU executor answered other queries than "
                             "the exact oracles leave")
    cpu_s = {q: t for q, (_, t) in cpu_answers_of.items()}
    for q, (want, _) in cpu_answers_of.items():
        if answers[q] != want:
            raise AssertionError(f"{q}: cuda {answers[q][1]!r:.200} != "
                                 f"cpu {want[1]!r:.200}")
    for q, (want, tol, rel) in moments.items():
        got = answers.get(q)
        if got is None:
            continue
        if got[0] != "float" or abs(got[1] - want) > tol * (
                abs(want) if rel else 1):
            raise AssertionError(f"{q}: engine {got} != numpy {want} "
                                 f"within {tol}{' relative' if rel else ''}")
        oracle[q] = got
    say("answers", equal_to_cpu=True,
        equal_to_oracle=sorted(
            q for q in (k.replace("{col5}", str(col5)).replace(
                "{after}", after) for k in oracle) if q in answers),
        counts={q: a[1] for q, a in answers.items() if a[0] == "value"},
        cpu_executor_s=cpu_s)
    # TopN's per-shard branch (taken above ROWS_STACKED_MAX_BYTES): the
    # (R, W) forms of kernel B, one launch per shard
    per_shard = Executor(holder)
    per_shard.ROWS_STACKED_MAX_BYTES = 0
    topn = [q for q in queries if q.startswith("TopN")]
    for q in topn:
        got = run(per_shard, q)
        if got != answers[q]:
            raise AssertionError(f"{q}: per-shard TopN {got} != stacked "
                                 f"{answers[q]}")
    say("topn_per_shard", equal_to_stacked=topn)
    group_paths(holder, queries, answers, run, reps)
    lap("answers")
    def timed(q) -> float:
        """One query as a caller runs it, to the synchronised answer (ms)."""
        rank_cache.clear()
        t0 = time.perf_counter()
        result = execute(gpu, q)
        if isinstance(result, Row):
            result.columns()   # the decode a caller needs, no list
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def p50(q) -> float:
        first = timed(q)
        return float(np.median([first] + [timed(q) for _ in range(
            runs_for(first, reps) - 1)]))
    latency = {q: p50(q) for q in queries}
    say("latency_p50_ms", **latency)
    lap("latency")
    per = query_profile(queries, timed, latency)
    # each new query ran the kernels it is meant to run
    meant = {"MinRow(field=f)": ("row_counts",),
             "MaxRow(field=f)": ("row_counts",),
             "Rows(f)": ("row_counts",),
             "UnionRows(Rows(g))": ("row_counts", "plan_eval"),
             "GroupBy(Rows(f))": ("row_counts",),
             "GroupBy(Rows(f), Rows(g))": ("pair_counts",),
             "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))":
                 ("bsi_sum_groups",),
             "GroupBy(Rows(f), Rows(g), having=Condition(count > 2500000))":
                 ("pair_counts",),
             "Count(Union(Row(f=1), Row(f=null)))": ("plan_eval",),
             "Sum(Row(f=null), field=v)": ("bsi_sum_planes",),
             "Min(Union(Row(g=1), Row(f=null)), field=v)": ("bsi_min_max",),
             "Max(Union(Row(g=1), Row(f=null)), field=v)": ("bsi_min_max",),
             "GroupBy(Rows(f), filter=Union(Row(g=1), Row(f=null)))":
                 ("row_counts",),
             PER_SHARD + "GroupBy(Rows(f), Rows(g))":
                 ("row_counts", "pair_counts"),
             PER_SHARD_SUM:
                 ("row_counts", "pair_counts", "bsi_sum_groups")}
    # the decode family (on warm caches: the stacked decode is cached, so
    # kernel G runs in the first pass, not here)
    meant.update({
        "Distinct(Row(f=1), field=g)": ("plan_eval", "row_counts"),
        "GroupBy(Rows(g), aggregate=Count(Distinct(field=v)))":
            ("row_counts", "plan_eval"),
        "Percentile(field=v, nth=50)": ("percentile_counts",),
        "Percentile(field=v, nth=99.9, filter=Row(f=1))":
            ("plan_eval", "percentile_counts"),
        "Sort(Row(f=1), field=v, limit=10)": ("plan_eval",),
        "Extract(Limit(Row(f=1), limit=1000), Rows(f), Rows(g), Rows(v))":
            ("plan_eval", "bsi_decode_gather"),
        "limits:Percentile(field=w, nth=50)": ("plan_eval", "bsi_min_max"),
        "limits:Extract(Limit(All(), limit=20), Rows(f), Rows(w))":
            ("plan_eval",),
        "Distinct(Union(Row(g=1), Row(f=null)), field=v)": ("bsi_decode",),
        "Sort(Union(Row(g=1), Row(f=null)), field=v, limit=10)":
            ("bsi_decode",),
        "Extract(Row(v == 42), Rows(v), Rows(g))":
            ("plan_eval", "bsi_decode_gather"),
        "keyed:Extract(All(), Rows(kf), Rows(n))": ("bsi_decode_gather",),
        "keyed:Distinct(field=kf)": ("row_counts",),
        "keyed:Sort(All(), field=n, limit=3)": ("plan_eval",)})
    # Var and Corr on the stacked route: kernel H, after kernel A's filter
    meant.update({
        "Var(field=v)": ("var_moments",),
        "Var(field=v, filter=Row(f=1))": ("plan_eval", "var_moments"),
        "Var(field=v, filter=Row(v > 5000))": ("plan_eval", "var_moments"),
        "Corr(field=v, field2=u)": ("corr_moments",),
        "Corr(field=v, field2=u, filter=Row(g=2))":
            ("plan_eval", "corr_moments")})
    for q in queries:
        if q.startswith("Options(GroupBy(Rows(f), Rows(g)"):
            meant[q] = ("plan_eval", "pair_counts")
        elif q.startswith("Options(GroupBy(Rows(f), aggregate"):
            meant[q] = ("bsi_sum_groups",)
        elif q.startswith("Options(Limit") or (
                q.startswith("limits:") and q[7:] in LIMIT_QUERIES[:7]):
            meant[q] = ("plan_eval",)
    for q, kernels in meant.items():
        for k in kernels:
            if q in per and per[q]["launches"][k] == 0:
                raise AssertionError(f"{q} did not launch {k}: "
                                     f"{per[q]['launches']}")
    say("query_kernels", meant={q: list(k) for q, k in meant.items()
                                if q in per})
    lap("query_profile")
    residency_phase(holder, queries, answers, run, resident["bytes"] // 2,
                    decode_queries)
    lap("residency")
    model = writes_phase(holder, gen, resident["bytes"] // 2)
    lap("writes")
    durable = api_phase(holder, model, queries, reps)
    lap("api")
    sql_phase(holder, model, reps)
    lap("sql")
    for k, v in mesh_phase(holder, min(reps, 5)).items():
        launches[k] += v
    lap("mesh")
    for k, v in server_phase(holder, queries, durable, reps).items():
        launches[k] += v
    lap("server")
    for k, v in ingest_phase(holder, queries).items():
        launches[k] += v
    lap("ingest")
    cluster_launches, shared = cluster_phase(holder, reps)
    for k, v in cluster_launches.items():
        launches[k] += v
    lap("cluster")
    for k, v in dax_phase(holder, reps, shared).items():
        launches[k] += v
    lap("dax")
    return launches


def mix_oracles(gen, col5: int, desc: np.ndarray) -> tuple:
    """(numpy's exact answers to the entries of the mix it holds, keyed by
    query with {col5} and {after} unreplaced where decode_oracles keys
    them so; the Percentile's rounds)."""
    oracle, rounds = decode_oracles(gen, col5, desc)
    f, g, v = gen["f"], gen["g"], gen["v"]
    at_g1, at_g2 = v[g == 1], v[g == 2]
    oracle.update({
        "Count(Intersect(Row(f=1), Row(g=2)))":
            ("value", int(((f == 1) & (g == 2)).sum())),
        "Count(Row(v > 5000))": ("value", int((v > 5000).sum())),
        "Sum(field=v)": ("valcount", (int(v.sum()), int(v.size))),
        "Min(field=v)": ("valcount", (int(v.min()),
                                      int((v == v.min()).sum()))),
        "Max(Row(g=2), field=v)": ("valcount", (
            int(at_g2.max()), int((at_g2 == at_g2.max()).sum()))),
        "Min(Union(Row(g=1), Row(f=null)), field=v)": ("valcount", (
            int(at_g1.min()), int((at_g1 == at_g1.min()).sum()))),
        "Max(Union(Row(g=1), Row(f=null)), field=v)": ("valcount", (
            int(at_g1.max()), int((at_g1 == at_g1.max()).sum()))),
    })
    top = np.bincount(f, minlength=8)
    order = sorted(range(8), key=lambda r: (-top[r], r))[:5]
    oracle["TopN(f, n=5)"] = ("pairs", [(r, int(top[r])) for r in order])
    oracle["Rows(f)"] = ("list", [r for r in range(8) if top[r]])
    oracle["GroupBy(Rows(f))"] = ("list", [((r,), int(top[r]), 0)
                                           for r in range(8) if top[r]])
    # the per-shard GroupBys: a bincount of the (f, g) pairs, and the
    # pairs' sums of v by a weighted bincount (float64 sums of integers
    # below 2^53: exact)
    pair = f * 4 + g
    n_pair = np.bincount(pair, minlength=32)
    s_pair = np.bincount(pair, weights=v, minlength=32).astype(np.int64)
    by_count = [((k // 4, k % 4), int(n_pair[k]), 0) for k in range(32)
                if n_pair[k]]
    by_sum = [((k // 4, k % 4), int(n_pair[k]), int(s_pair[k]))
              for k in range(32) if n_pair[k]]
    if [x[:2] for x in by_count] != [x[:2] for x in by_sum]:
        raise AssertionError("the two GroupBy oracles disagree on counts")
    oracle["GroupBy(Rows(f), Rows(g))"] = ("list", by_count)
    oracle["GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))"] = (
        "list", by_sum)
    oracle["GroupBy(Rows(f), Rows(g), having=Condition(count > 2500000))"] \
        = ("list", [x for x in by_count if x[1] > 2500000])
    oracle[PER_SHARD + "GroupBy(Rows(f), Rows(g))"] = ("list", by_count)
    first32 = (gen["cols"] >> 20) < 32
    s32 = np.bincount(pair[first32], weights=v[first32],
                      minlength=32).astype(np.int64)
    n32 = np.bincount(pair[first32], minlength=32)
    oracle[PER_SHARD_SUM] = ("list", [((k // 4, k % 4), int(n32[k]),
                                       int(s32[k])) for k in range(32)
                                      if n32[k]])
    top_g1 = np.bincount(f[g == 1], minlength=8)
    oracle["GroupBy(Rows(f), filter=Union(Row(g=1), Row(f=null)))"] = (
        "list", [((r,), int(top_g1[r]), 0) for r in range(8) if top_g1[r]])
    return oracle, rounds


def exact_queries(oracle: dict, col5: int, after: str) -> set:
    """The mix's entries an exact oracle holds (the CPU executor is not
    asked about them)."""
    return {q.replace("{col5}", str(col5)).replace("{after}", after)
            for q in oracle}


def var64(x: np.ndarray) -> float:
    """numpy's float64 Var of `x`."""
    return float(np.var(x.astype(np.float64)))


def corr64(x: np.ndarray, y: np.ndarray) -> float:
    """numpy's float64 Corr of `x` and `y`."""
    return float(np.corrcoef(x.astype(np.float64),
                             y.astype(np.float64))[0, 1])


def moment_oracles(gen) -> dict:
    """numpy's answers to MOMENT_QUERIES: query -> (value, tolerance,
    relative).  Absolute 1e-6 (the answers are rounded to 6 places);
    relative 1e-9 for the depth-43 Var, whose float64 sums of squares near
    2.5e25 cancel to a variance near 2e24 (the engine's float64 route, as
    the reference's, is exact to about 1e-15 of it)."""
    f, g, v, u, uh = gen["f"], gen["g"], gen["v"], gen["u"], gen["u_has"]
    lim = gen["limits"]
    first32 = (gen["cols"] >> 20) < 32
    var, corr = var64, corr64
    return {
        "Var(field=v)": (var(v), 1e-6, False),
        "Var(field=v, filter=Row(f=1))": (var(v[f == 1]), 1e-6, False),
        "Var(field=v, filter=Row(v > 5000))": (var(v[v > 5000]), 1e-6, False),
        "Corr(field=v, field2=u)": (corr(v[uh], u[uh]), 1e-6, False),
        "Corr(field=v, field2=u, filter=Row(g=2))": (
            corr(v[uh & (g == 2)], u[uh & (g == 2)]), 1e-6, False),
        MOMENT_QUERIES[5]: (var(v[(g == 1) & first32]), 1e-6, False),
        "limits:Var(field=w)": (var(lim["w"]), 1e-9, True),
        "limits:Corr(field=w, field2=a)": (corr(lim["w"], lim["a"]), 1e-6,
                                           False),
    }


def exact_moment(x: np.ndarray, y=None):
    """The engine's answer to a Var of the integer values `x` (a Corr of x
    and `y`) of a field at scale 0, as the bench table's v and u: numpy's
    exact integer moments, finished by Executor.var_of (corr_of), which
    finish kernel H''s exact moments (ops/bsi.py finalize_*_moments)."""
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.model.field import Field, FieldOptions
    f = Field("bench", "v", FieldOptions(type="int"))
    x = x.astype(np.int64)
    if y is None:
        return Executor.var_of(f, int(x.size), int(x.sum()),
                               int((x * x).sum()))
    y = y.astype(np.int64)
    return Executor.corr_of(f, f, int(x.size), int(x.sum()), int(y.sum()),
                            int((x * y).sum()), int((x * x).sum()),
                            int((y * y).sum()))


def exact_moments(gen) -> dict:
    """The engine's exact answers (canon forms, exact_moment) to the mix's
    Var and Corr on kernel H''s route: the bench table's v and u (depths
    14 and 12) under plannable filters.  The other entries of
    MOMENT_QUERIES take the float64 host route, and the CPU executor
    answers them."""
    f, g, v, u, uh = gen["f"], gen["g"], gen["v"], gen["u"], gen["u_has"]
    return {q: ("float", a) for q, a in (
        ("Var(field=v)", exact_moment(v)),
        ("Var(field=v, filter=Row(f=1))", exact_moment(v[f == 1])),
        ("Var(field=v, filter=Row(v > 5000))", exact_moment(v[v > 5000])),
        ("Corr(field=v, field2=u)", exact_moment(v[uh], u[uh])),
        ("Corr(field=v, field2=u, filter=Row(g=2))",
         exact_moment(v[uh & (g == 2)], u[uh & (g == 2)])))}


def group_paths(holder, queries, answers, run, reps: int) -> dict:
    """Phase 5a: each GroupBy of two dimensions or with a Sum that the mix
    sends to the stacked path or to the one-launch path, through both: the
    stacked path (the mask cap raised to 4 GB, so that it takes the
    128-shard ones too) and the one-launch path (the cap lowered to 8 MB,
    under what every shard's masks need and over what one shard's do).
    Answers equal the first pass's; p50 of `reps` runs each, the two paths
    in turns."""
    from featurebase_tpu_torch.executor.executor import Executor
    caps = {"stacked": 4 << 30, "launch": 8 << 20}
    ex, seen = {}, {}
    for name, cap in caps.items():
        e = ex[name] = Executor(holder)
        e.GROUPBY_ONESHOT_MAX_MASK_BYTES = cap
        seen[name] = log = []
        for path in ("stacked", "launch"):
            real = getattr(e, f"_group_by_{path}")

            def spy(*a, real=real, path=path, log=log):
                r = real(*a)
                log.append((path, r))
                return r
            setattr(e, f"_group_by_{path}", spy)
    want_log = {"stacked": [("stacked", True)],
                "launch": [("stacked", False), ("launch", True)]}
    out = {}
    for q in queries:
        if "null" in q or q.startswith(PER_SHARD) or not (
                "GroupBy(Rows(f), Rows(g)" in q or "aggregate=Sum" in q):
            continue
        times = {name: [] for name in caps}
        for i in range(reps + 1):
            for name, e in ex.items():
                seen[name].clear()
                t0 = time.perf_counter()
                got = run(e, q)
                torch.cuda.synchronize()
                if i:   # the first run of each fills the caches
                    times[name].append((time.perf_counter() - t0) * 1e3)
                if got != answers[q]:
                    raise AssertionError(f"{q} on the {name} path: "
                                         f"{got[1]!r:.200} != "
                                         f"{answers[q][1]!r:.200}")
                if seen[name] != want_log[name]:
                    raise AssertionError(f"{q} missed the {name} path: "
                                         f"{seen[name]}")
        out[q] = {f"{name}_p50_ms": float(np.median(t))
                  for name, t in times.items()}
    say("group_paths", caps=caps, queries=out)
    return out


def residency_phase(holder, queries, answers, run, budget: int,
                    decode_queries) -> dict:
    """Phase 5b: every device cache dropped, then the whole mix again by a
    fresh executor under a residency budget of about half the bytes the
    first pass left resident: the decode family first, then the rest of the
    mix, then the decode family again.  Every answer must be unchanged, the
    LRU must evict, and after each query its bytes must be within the
    budget (or one entry larger than the budget must be all that is left);
    the stacked decode's cache (PlanExecutor.stacked_vals, 537 MB at 128
    shards) must be evicted and decoded again."""
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.storage import residency
    residency.residency().set_budget(0)   # evicts every earlier entry
    mgr = residency.reset(budget)
    gpu = Executor(holder)
    peak = 0
    rest = [q for q in queries if q not in decode_queries]
    seen, evicted = set(), set()
    decodes = ck.launches()["bsi_decode"]
    for q in decode_queries + rest + decode_queries:
        got = run(gpu, q)
        if got != answers[q]:
            raise AssertionError(f"{q} under a budget of {budget} bytes: "
                                 f"{got[1]!r:.200} != {answers[q][1]!r:.200}")
        st = mgr.stats()
        if st["bytes"] > budget and st["entries"] > 1:
            raise AssertionError(f"{q}: {st['bytes']} bytes resident over a "
                                 f"budget of {budget}: {st}")
        peak = max(peak, st["bytes"])
        vals = {k for k in gpu.plan_executor._leaf_cache if k[0] == "vals"}
        evicted |= seen - vals
        seen |= vals
    st = mgr.stats()
    if st["evictions"] == 0:
        raise AssertionError(f"no eviction under a budget of {budget}: {st}")
    bench_vals = [k for k in evicted if k[1] == "bench"]
    if not bench_vals:
        raise AssertionError(f"the stacked decode of the bench index was "
                             f"never evicted under {budget} bytes: {st}")
    say("residency", budget=budget, answers_unchanged=True,
        peak_bytes_after_query=peak, stats=st,
        stacked_vals_evicted=[list(k[:4]) for k in evicted],
        bsi_decode_launches=ck.launches()["bsi_decode"] - decodes)
    return st


# the reads of the writes phase, before and after the writes
WRITE_READS = [
    "Count(Row(f=1))",
    "Count(Row(f=9))",
    "Count(All())",
    "TopN(f, n=5)",
    "Sum(field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "MinRow(field=f)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "Distinct(field=v)",
    "Percentile(field=v, nth=50)",
    "Var(field=v)",
    "Corr(field=v, field2=u)",
    "keyed:Count(All())",
    "keyed:Extract(All(), Rows(kf), Rows(n))",
    "keyed:Distinct(field=kf)",
]
WRITE_ROWS = 10   # rows of f after the writes: 0-8 set, 9 stored
# the reads every round of writes changes (Distinct, Percentile, Min and
# Max of v may keep their answers)
WRITES_CHANGE = [q for q in WRITE_READS if "Distinct" not in q and
                 "Percentile" not in q and not q.startswith(("Min(", "Max("))]


class WriteModel:
    """The bench table's records as numpy arrays that follow the writes:
    f and g as (records, rows) bits, v and u with their presence, and the
    records that exist."""

    def __init__(self, gen):
        n = gen["f"].size
        self.cols = gen["cols"]
        self.F = np.zeros((n, WRITE_ROWS), dtype=bool)
        self.F[np.arange(n), gen["f"]] = True
        self.G = np.zeros((n, 4), dtype=bool)
        self.G[np.arange(n), gen["g"]] = True
        self.v = gen["v"].astype(np.int64).copy()
        self.u = gen["u"]
        self.u_has = gen["u_has"].copy()
        self.alive = np.ones(n, dtype=bool)

    def float64(self) -> dict:
        """numpy's float64 Var and Corr of WRITE_READS, which the card's
        answers hold within 1e-6 beside oracle()'s exact forms."""
        uv = self.alive & self.u_has
        return {"Var(field=v)": var64(self.v[self.alive]),
                "Corr(field=v, field2=u)": corr64(self.v[uv], self.u[uv])}

    def oracle(self) -> dict:
        """The reads of WRITE_READS on the bench index, by numpy, in canon
        forms (Var and Corr exact: exact_moment)."""
        F, G, v, alive = self.F, self.G, self.v, self.alive
        va = v[alive]
        # each record's f rows (bits 0-9) and g row (bits 10-13: G holds
        # one a record in the writes phase, none once deleted) as one
        # 16-bit key, its bool bytes gathered 8 at a time by a multiply
        # (byte i of a little-endian word to bit 56 + i); one bincount of
        # the keys and one weighted by v (float64 sums of integers below
        # 2^53: exact), rows g 0-3 and none, spread over the masks' rows by
        # a product with the masks' bits
        b = np.zeros((F.shape[0], 16), dtype=np.uint8)
        b[:, :WRITE_ROWS] = F
        b[:, WRITE_ROWS:WRITE_ROWS + 4] = G
        eight = (b.view(np.uint64) * np.uint64(0x0102040810204080)) \
            >> np.uint64(56)
        key = (eight[:, 0] | (eight[:, 1] << np.uint64(8))).astype(np.int64)
        rows = [1, 2, 4, 8, 0]   # the g bits of g rows 0-3, then of none
        bits = (np.arange(1 << WRITE_ROWS)[:, None]
                >> np.arange(WRITE_ROWS)) & 1
        n_c = np.bincount(key, minlength=1 << 14).reshape(16, -1)[rows] \
            @ bits
        s_c = np.bincount(key, weights=v, minlength=1 << 14).reshape(
            16, -1)[rows] @ bits
        top = n_c.sum(0)
        by_count, by_sum = [], []
        for r in range(WRITE_ROWS):
            for q in range(4):
                if n_c[q, r]:
                    by_count.append(((r, q), int(n_c[q, r]), 0))
                    by_sum.append(((r, q), int(n_c[q, r]),
                                   int(s_c[q, r])))
        r0 = int(np.flatnonzero(top)[0])
        uv = alive & self.u_has
        vals = [int(x) for x in sorted_unique(va)]
        return {
            "Count(Row(f=1))": ("value", int(top[1])),
            "Count(Row(f=9))": ("value", int(top[9])),
            "Count(All())": ("value", int(alive.sum())),
            "TopN(f, n=5)": ("pairs", [
                (r, int(top[r])) for r in sorted(
                    range(WRITE_ROWS), key=lambda r: (-top[r], r))[:5]
                if top[r]]),
            "Sum(field=v)": ("valcount", (int(va.sum()), int(va.size))),
            "Min(field=v)": ("valcount", (int(va.min()),
                                          int((va == va.min()).sum()))),
            "Max(field=v)": ("valcount", (int(va.max()),
                                          int((va == va.max()).sum()))),
            "MinRow(field=f)": ("pair", (r0, int(top[r0]))),
            "GroupBy(Rows(f), Rows(g))": ("list", by_count),
            "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))":
                ("list", by_sum),
            "Distinct(field=v)": ("signed", (len(vals), digest(vals))),
            "Percentile(field=v, nth=50)":
                ("valcount", oracle_percentile(va, 50)[0]),
            "Var(field=v)": ("float", exact_moment(va)),
            "Corr(field=v, field2=u)": ("float", exact_moment(
                v[uv], self.u[uv])),
        }


def write_round(gpu, model: WriteModel, rng, rnd: int) -> dict:
    """One round of PQL writes through `gpu`, each answer held against the
    model, which follows them: 1000 Sets of f over every shard, 200 Sets
    of v (one out of range: an error, and no change), 100 Clears of f,
    ClearRow(f=7), Store(Intersect(Row(f=1), Row(g=2)), f=9) (three times:
    the first writes), Delete(Row(v == 42 + rnd)) (three times: the first
    deletes), and on the keyed index a Set with a new record key and a
    Delete.  Returns the host ms of each kind."""
    cols = model.cols
    live = np.flatnonzero(model.alive)
    times = {"set_ms": [], "set_int_ms": [], "clear_ms": []}

    def run(q, key=None):
        t0 = time.perf_counter()
        got = gpu.execute("bench", q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if key is not None:
            times[key].append(ms)
        return got, ms
    for i, r in zip(rng.choice(live, 1000, replace=False),
                    rng.integers(0, 9, 1000)):
        got, _ = run(f"Set({int(cols[i])}, f={int(r)})", "set_ms")
        if got != [not model.F[i, r]]:
            raise AssertionError(f"Set f={r} at record {i}: {got}")
        model.F[i, r] = True
    picks = rng.choice(live, 200, replace=False)
    for k, i in enumerate(picks):
        new = 20000 if k == 100 else int(rng.integers(-1000, 10000))
        try:
            got, _ = run(f"Set({int(cols[i])}, v={new})", "set_int_ms")
        except Exception as e:   # ExecError: above the field's maximum
            if new != 20000 or "maximum" not in str(e):
                raise
            continue
        if new == 20000:
            raise AssertionError("an out-of-range Set was taken")
        if got != [bool(model.v[i] != new)]:
            raise AssertionError(f"Set v={new} at record {i}: {got}")
        model.v[i] = new
    has = live[model.F[live].any(1)]
    for i in rng.choice(has, 100, replace=False):
        r = int(np.flatnonzero(model.F[i])[0])
        got, _ = run(f"Clear({int(cols[i])}, f={r})", "clear_ms")
        if got != [True]:
            raise AssertionError(f"Clear f={r} at record {i}: {got}")
        model.F[i, r] = False
    got, times["clear_row_ms"] = run("ClearRow(f=7)")
    if got != [bool(model.F[:, 7].any())]:
        raise AssertionError(f"ClearRow(f=7): {got}")
    model.F[:, 7] = False
    times["store_ms"] = []
    for _ in range(3):
        got, ms = run("Store(Intersect(Row(f=1), Row(g=2)), f=9)")
        times["store_ms"].append(ms)
        if got != [True]:
            raise AssertionError(f"Store: {got}")
    model.F[:, 9] = model.F[:, 1] & model.G[:, 2]
    gone = model.alive & (model.v == 42 + rnd)
    times["delete_ms"] = []
    for k in range(3):
        got, ms = run(f"Delete(Row(v == {42 + rnd}))")
        times["delete_ms"].append(ms)
        if got != [bool(gone.any()) and k == 0]:
            raise AssertionError(f"Delete #{k}: {got}")
    model.F[gone] = False
    model.G[gone] = False
    model.u_has[gone] = False
    model.alive[gone] = False
    k0 = gpu.execute("keyed", f'Set("new-{rnd}", kf="delta")')
    k1 = gpu.execute("keyed", f"Delete(Row(s={rnd}))")
    store = gpu.holder.index("keyed").translate_store
    if f"new-{rnd}" not in store.find_keys([f"new-{rnd}"]):
        raise AssertionError("the keyed Set created no record key")
    say("writes_round", round=rnd, keyed_answers=[k0, k1],
        deleted_records=int(gone.sum()),
        **{k: (v if len(v) <= 3 else dict(n=len(v), p50=float(np.median(v)),
                                          max=float(np.max(v))))
           for k, v in times.items() if isinstance(v, list)},
        clear_row_ms=times["clear_row_ms"])
    return times


def writes_phase(holder, gen, budget: int) -> "WriteModel":
    """Phase 5c, after every read phase: PQL writes on the bench and keyed
    indexes, and the reads of WRITE_READS before and after them.  Round 1
    at the default residency budget: the reads first fill every device
    cache (the plan executor's leaves and its stacked decode, the rank
    cache, the fragment mirrors), then the writes (write_round), then the
    reads again: each answer equal to the numpy model of the writes (Var
    and Corr exactly, exact_moment), and each that the model does not hold
    equal to a CPU executor's over the same Holder; the first read after
    the writes timed beside the p50 of five more (the gap is the caches'
    refresh).
    Round 2 the same under `budget` bytes, with a fresh executor and new
    writes.  Returns the model of the written table."""
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.storage import residency
    model = WriteModel(gen)
    rng = np.random.default_rng(41)
    out = {}
    for rnd, bud in ((1, None), (2, budget)):
        residency.residency().set_budget(0)
        mgr = residency.reset(bud)
        gpu, cpu = Executor(holder), Executor(holder, device="cpu")

        def timed(q) -> tuple:
            t0 = time.perf_counter()
            got = canon(execute(gpu, q))
            torch.cuda.synchronize()
            return got, (time.perf_counter() - t0) * 1e3
        before = {q: timed(q)[0] for q in WRITE_READS}
        cached = dict(leaves=len(gpu.plan_executor._leaf_cache),
                      rank_cache=len(holder.index("bench").field("f")
                                     ._topn_cache),
                      resident=mgr.stats()["bytes"])
        times = write_round(gpu, model, rng, rnd)
        want, want64 = model.oracle(), model.float64()
        first, p50, cpu_s, after = {}, {}, {}, {}
        for q in WRITE_READS:   # the card's reads first: the CPU executor
            # moves the fragment mirrors it reads to the host
            after[q], first[q] = timed(q)
            again = [timed(q) for _ in range(5)]
            p50[q] = float(np.median([ms for _, ms in again]))
            if any(a != after[q] for a, _ in again):
                raise AssertionError(f"{q} after writes: answers differ "
                                     "between runs")
        for q in WRITE_READS:
            got = after[q]
            w = want.get(q)
            # a CPU executor's answer for each read that numpy does not
            # hold (the keyed reads)
            if w is None:
                t0 = time.perf_counter()
                c = canon(execute(cpu, q))
                cpu_s[q] = time.perf_counter() - t0
                if got != c:
                    raise AssertionError(
                        f"{q} after writes (round {rnd}): cuda "
                        f"{got[1]!r:.200} != cpu {c[1]!r:.200}")
            elif got != w:
                raise AssertionError(f"{q} after writes: {got!r:.300} != "
                                     f"numpy {w!r:.300}")
            if q in want64 and abs(got[1] - want64[q]) > 1e-6:
                raise AssertionError(f"{q} after writes: {got[1]} != numpy "
                                     f"float64 {want64[q]} within 1e-6")
            if bud is not None and mgr.stats()["bytes"] > bud and \
                    mgr.stats()["entries"] > 1:
                raise AssertionError(f"{q}: over the budget {bud}: "
                                     f"{mgr.stats()}")
        changed = sorted(q for q in WRITE_READS if after[q] != before[q])
        out[rnd] = dict(budget=mgr.budget, caches_before_writes=cached,
                        first_read_ms=first, cached_p50_ms=p50,
                        cpu_executor_s=cpu_s, changed_by_writes=changed,
                        residency=mgr.stats(),
                        set_p50_ms=float(np.median(times["set_ms"])),
                        set_int_p50_ms=float(np.median(times["set_int_ms"])),
                        store_p50_ms=float(np.median(times["store_ms"])),
                        delete_ms=times["delete_ms"])
        say("writes", round=rnd, equal_to_cpu=True, equal_to_numpy=sorted(
            q for q in WRITE_READS if q in want), **out[rnd])
        missed = set(WRITES_CHANGE) - set(changed)
        if missed:
            raise AssertionError(f"round {rnd}: the writes left {missed} "
                                 "unchanged")
    return model


# the queries whose host overhead the api phase measures, through the API
# beside the Executor
API_OVERHEAD = ["Count(Intersect(Row(f=1), Row(g=2)))", "TopN(f, n=5)",
                "Sum(field=v)", "GroupBy(Rows(f), Rows(g))", "Var(field=v)"]
# the Apply of the api phase: about 2.5 M of the 80 M records
APPLY_FILTER = "Intersect(Row(f=1), Row(g=2))"
APPLY_PROGRAM = "v * 2 + u"
APPLY_REDUCES = ("sum", "mean", "count", "min", "max")
API_SHARDS = 16   # the durability check's index (a cut: see api_durability)


def api_query(api, q: str):
    """A QUERIES entry through API.query (execute() over the API's
    executor)."""
    return execute(api.executor, q, lambda index, pql: api.query(index,
                                                                 pql)[0])


def apply_oracle(model: "WriteModel") -> tuple:
    """numpy's Apply(APPLY_FILTER, APPLY_PROGRAM) over the written table:
    (values with None where u is absent, the reduces)."""
    m = model.alive & model.F[:, 1] & model.G[:, 2]
    x = 2 * model.v[m] + model.u[m].astype(np.int64)
    has = model.u_has[m]
    vals = [int(a) if h else None for a, h in zip(x.tolist(), has.tolist())]
    nums = x[has]
    red = {"sum": int(nums.sum()), "count": int(m.sum()),
           "mean": float(nums.sum()) / nums.size,
           "min": int(nums.min()), "max": int(nums.max())}
    return vals, red


def api_phase(holder, model: "WriteModel", queries, reps: int) -> dict:
    """Phase 5d, after the writes: the port's API front end
    (featurebase_tpu_torch.server.api) over the bench holder on the card.
    (1) Every query of the mix through API.query, the launch counters set
    to 0 just before and read just after (every kernel must run), each
    answer equal to an Executor's over the same (written) holder; the p50
    of API_OVERHEAD through both, in turns.  (2) Apply(APPLY_FILTER,
    APPLY_PROGRAM) and its reduces against numpy (apply_oracle): one
    kernel-A launch for the filter and one G''' launch a field and
    residency batch; the reduces' p50 and busy share under the profiler.
    (3) Arrow over about 100,000 dataframe rows of four shards, and
    ExternalLookup over a sqlite3 table, against numpy.  (4) Durability:
    api_durability.  (5) Last use of the bench index: g deleted and
    created again with new rows, its copies' residency bytes released, and
    Count and TopN on g equal to numpy."""
    import sqlite3

    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.storage import residency
    from featurebase_tpu_torch.storage.lookup import SQLiteLookup
    t_phase = time.perf_counter()
    residency.residency().set_budget(0)
    mgr = residency.reset()
    api, gpu = API(holder=holder), Executor(holder)
    rank_cache = holder.index("bench").field("f")._topn_cache
    got = {}
    ck.reset_launches()
    t0 = time.perf_counter()
    for q in queries:
        rank_cache.clear()
        got[q] = canon(api_query(api, q))
    torch.cuda.synchronize()
    api_pass_s = time.perf_counter() - t0
    launches = ck.launches()
    if not all(launches.values()):
        raise AssertionError(f"the mix through the API left a kernel "
                             f"unlaunched: {launches}")
    for q in queries:
        rank_cache.clear()
        want = canon(execute(gpu, q))
        if got[q] != want:
            raise AssertionError(f"{q}: API {got[q]!r:.200} != Executor "
                                 f"{want!r:.200}")

    def ms(fn) -> float:
        rank_cache.clear()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    overhead = {}
    for q in API_OVERHEAD:
        runs = [(ms(lambda: api.query("bench", q)),
                 ms(lambda: gpu.execute("bench", q))) for _ in range(reps)]
        a, e = (float(np.median([r[i] for r in runs])) for i in (0, 1))
        overhead[q] = dict(api_p50_ms=a, executor_p50_ms=e,
                           overhead_ms=a - e)
    say("api_mix", nvidia_smi=card_line(), queries=len(queries),
        equal_to_executor=True, api_pass_s=api_pass_s,
        api_pass_launches=launches, overhead=overhead)

    # (2) Apply over the bench index
    vals, red = apply_oracle(model)
    idx = holder.index("bench")
    shard_list = idx.available_shards()
    batches = sum(
        sum(1 for b in api.executor._residency_batches(
            shard_list, [idx.field(f).bsi_view()]) if any(
                idx.field(f).bsi_view().fragment(s) is not None for s in b))
        for f in ("v", "u"))
    ck.reset_launches()
    t0 = time.perf_counter()
    (out,) = api.query("bench", f'Apply({APPLY_FILTER}, "{APPLY_PROGRAM}")')
    apply_ms = (time.perf_counter() - t0) * 1e3
    apply_launches = ck.launches()
    if out != vals:
        raise AssertionError(f"Apply: {len(out)} values != numpy's "
                             f"{len(vals)} (or they differ)")
    want_l = {"plan_eval": 1, "bsi_decode_gather": batches}
    if {k: apply_launches[k] for k in want_l} != want_l or any(
            n for k, n in apply_launches.items() if k not in want_l):
        raise AssertionError(f"Apply launched {apply_launches}, not "
                             f"{want_l}")
    red_q = [f'Apply({APPLY_FILTER}, "{APPLY_PROGRAM}", "{r}")'
             for r in APPLY_REDUCES]
    for r, q in zip(APPLY_REDUCES, red_q):
        (g,) = api.query("bench", q)
        if g != [red[r]]:
            raise AssertionError(f"{q}: {g} != numpy {red[r]}")

    def timed(q) -> float:
        return ms(lambda: api.query(*index_of(q)))

    def p50(q) -> float:
        first = timed(q)
        return float(np.median([first] + [timed(q) for _ in range(
            runs_for(first, reps) - 1)]))
    latency = {q: p50(q) for q in red_q}
    prof = query_profile(red_q, timed, latency, phase="api_apply_profile")
    say("api_apply", nvidia_smi=card_line(), records=len(vals),
        nonnull=sum(v is not None for v in vals),
        equal_to_numpy=True, list_ms=apply_ms, launches=apply_launches,
        reduces=red, p50_ms=latency,
        busy_share={q: prof[q]["busy_share"] for q in red_q})

    # (3) Arrow and ExternalLookup
    rng = np.random.default_rng(43)
    cols = model.cols
    df_ids = []
    for s in range(4):
        ids = cols[(cols >> 20) == s][:25_000]
        api.dataframe_ingest("bench", s, columns={
            "_id": ids, "price": ids % 1000 / 4.0, "qty": ids % 97})
        df_ids.append(ids)
    df_ids = np.concatenate(df_ids)
    f1 = set(cols[model.alive & model.F[:, 1]].tolist())
    want_ids = [int(i) for i in df_ids if int(i) in f1]
    t0 = time.perf_counter()
    (arrow,) = api.query("bench", "Arrow(Row(f=1))")
    arrow_ms = (time.perf_counter() - t0) * 1e3
    if (arrow["columns"]["_id"] != want_ids
            or arrow["columns"]["qty"] != [i % 97 for i in want_ids]
            or arrow["columns"]["price"] != [i % 1000 / 4.0
                                             for i in want_ids]):
        raise AssertionError("Arrow(Row(f=1)) differs from numpy")
    db = SQLiteLookup(":memory:")
    near = model.alive & (model.v >= 40) & (model.v <= 45)
    conn = db._conn()
    conn.execute("CREATE TABLE ext (id INTEGER PRIMARY KEY, v INTEGER)")
    conn.executemany("INSERT INTO ext VALUES (?, ?)",
                     zip(cols[near].tolist(), model.v[near].tolist()))
    conn.commit()
    holder.lookup_db = db
    t0 = time.perf_counter()
    (tbl,) = api.query("bench", 'ExternalLookup(Row(v == 42), query="SELECT '
                                'id, v * 10 FROM ext WHERE id IN $1 ORDER '
                                'BY id")')
    lookup_ms = (time.perf_counter() - t0) * 1e3
    want42 = cols[model.alive & (model.v == 42)].tolist()
    if [(c.column, c.rows) for c in tbl.columns] != \
            [(c, [420]) for c in want42]:
        raise AssertionError("ExternalLookup(Row(v == 42)) differs from "
                             "numpy")
    holder.lookup_db = None
    say("api_arrow_lookup", nvidia_smi=card_line(),
        dataframe_rows=int(df_ids.size), arrow_rows=len(want_ids),
        arrow_ms=arrow_ms, lookup_rows=len(want42), lookup_ms=lookup_ms,
        equal_to_numpy=True, sqlite=sqlite3.sqlite_version)

    # (4) durability, on its own 16-shard index
    durable = api_durability(rng)

    # (5) delete and recreate g on the warm API: the bench holder's last use
    for q in ("Count(Row(g=2))", "TopN(g)", "GroupBy(Rows(f), Rows(g))"):
        api.query("bench", q)
    # g's device copies: its fragments' mirrors and the stacked entries
    # both executors gathered from them
    gfrags = [fr for v in idx.field("g").views.values()
              for fr in v.fragments.values()]
    ids = {id(fr) for fr in gfrags}
    gkeys = [k for k in (fr._residency_key() for fr in gfrags)
             if k in mgr._entries] + \
        api.executor.plan_executor.built_from(ids) + \
        gpu.plan_executor.built_from(ids)
    held = sum(mgr._entries[k][0] for k in gkeys)
    before = mgr.bytes
    t0 = time.perf_counter()
    api.delete_field("bench", "g")
    delete_ms = (time.perf_counter() - t0) * 1e3
    after = mgr.bytes
    if before - after != held or any(k in mgr._entries for k in gkeys):
        raise AssertionError(f"delete_field(g) released {before - after} "
                             f"bytes of the {held} its copies held")
    api.create_field("bench", "g")
    pick = np.flatnonzero(model.alive)[::8]
    new_g = rng.integers(0, 6, pick.size)
    api.import_bits("bench", "g", new_g, cols[pick])
    # the model follows: g's rows are new (the sql phase reads them)
    model.G = np.zeros((model.cols.size, 6), dtype=bool)
    model.G[pick, new_g] = True
    counts = np.bincount(new_g, minlength=6)
    (n2,) = api.query("bench", "Count(Row(g=2))")
    (top,) = api.query("bench", "TopN(g)")
    want_top = sorted(((r, int(c)) for r, c in enumerate(counts) if c),
                      key=lambda rc: (-rc[1], rc[0]))
    if n2 != int(counts[2]) or [(p.id, p.count) for p in top.pairs] != \
            want_top:
        raise AssertionError(f"after recreating g: Count {n2}, TopN "
                             f"{[(p.id, p.count) for p in top.pairs]} != "
                             f"numpy {int(counts[2])}, {want_top}")
    say("api_recreate", nvidia_smi=card_line(), g_copies=len(gkeys),
        released_bytes=before - after, held_bytes=held,
        delete_ms=delete_ms, count_g2=n2, topn_g=want_top,
        equal_to_numpy=True, phase_s=time.perf_counter() - t_phase)
    return durable


def api_durability(rng) -> dict:
    """An API with a data directory over a 16-shard index built as the
    bench table is (a cut from the bench's 128: np.savez_compressed of 128
    shards would take tens of seconds): the table handed to the API,
    imports and PQL writes through it, checkpoint (the save), more writes
    (the WAL), then a second API over the directory (the snapshot's load
    and the WAL's replay) must answer DURABLE_READS as the first did.
    Returns the directory (dir, its scratch parent, shards), which the
    server phase serves from a child process and then removes."""
    import shutil
    import tempfile

    from featurebase_tpu_torch.server.api import API

    class TimedAPI(API):
        def _replay_wal(self):
            t0 = time.perf_counter()
            super()._replay_wal()
            self.replay_s = time.perf_counter() - t0
    scratch = tempfile.mkdtemp(prefix="api-durability-",
                               dir=os.path.dirname(os.path.abspath(__file__)))
    done = False
    try:
        holder, gen = build_table(API_SHARDS, seed=7)
        d = os.path.join(scratch, "node")
        api = API(holder=holder, data_dir=d)
        cols = gen["cols"]
        api.create_field("bench", "h")
        api.import_bits("bench", "h", rng.integers(0, 3, 10_000), cols[:10_000])
        api.import_values("bench", "v", cols[-500:], rng.integers(0, 100, 500))
        for c in cols[rng.choice(cols.size, 200, replace=False)]:
            api.query("bench", f"Set({int(c)}, f=9) Set({int(c)}, v=4242)")
        t0 = time.perf_counter()
        api.checkpoint()
        save_s = time.perf_counter() - t0
        snap_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(os.path.join(d, "snapshot"))
                         for f in fs)
        api.query("bench", "Delete(Row(v == 4242))")
        api.query("bench", "ClearRow(f=3) Store(Row(g=1), f=3)")
        api.import_bits("bench", "h", [5] * 100, cols[:100])
        api.query("keyed", 'Set("late", kf="omega")')
        want = {q: canon(api_query(api, q)) for q in DURABLE_READS}
        t0 = time.perf_counter()
        again = TimedAPI(data_dir=d)
        open_s = time.perf_counter() - t0
        got = {q: canon(api_query(again, q)) for q in DURABLE_READS}
        if got != want or again.wal_replay_errors:
            bad = [q for q in DURABLE_READS if got[q] != want[q]]
            raise AssertionError(f"the reopened API differs on {bad} "
                                 f"({again.wal_replay_errors} replay errors)")
        with open(os.path.join(d, "wal.jsonl")) as fh:
            wal_entries = sum(1 for _ in fh)
        say("api_durability", nvidia_smi=card_line(), shards=API_SHARDS,
            reduced=dict(shards=f"{API_SHARDS} of 128"),
            records=int(cols.size), snapshot_bytes=snap_bytes,
            save_s=save_s, open_s=open_s, replay_s=again.replay_s,
            load_s=open_s - again.replay_s, wal_entries=wal_entries,
            reads=len(DURABLE_READS), equal_after_restart=True)
        done = True
        return dict(dir=d, scratch=scratch, shards=API_SHARDS)
    finally:
        if not done:
            shutil.rmtree(scratch, ignore_errors=True)


DURABLE_READS = [
    "Count(All())", "Count(Intersect(Row(f=1), Row(g=2)))", "TopN(f, n=5)",
    "Count(Row(f=9))", "Count(Row(f=3))", "Sum(field=v)", "Max(field=v)",
    "GroupBy(Rows(f), Rows(g))", "Rows(h)", "Count(Row(h=5))",
    "Var(field=v)", "Distinct(Row(h=1), field=g)",
    "keyed:Extract(All(), Rows(kf), Rows(n))", "limits:Count(Row(w > 5))"]

# -- the sql phase ----------------------------------------------------------

def _scalar(r) -> list:
    return [[r[0]]]


def _vals(r) -> list:
    return [[x.val for x in r]]


def _sum_avg(r) -> list:
    s, a = r
    return [[s.val, a.val / a.count if a.count else None]]


# The pushdown mix of the sql phase: (statement, its PQL counterpart (the
# calls the planner lowers it to), the counterpart's results reshaped as the
# statement's rows, the kernels it is meant to launch).  The SUM/AVG, MIN/MAX
# pairs lower to one call an aggregate; a scan's Extract takes the columns it
# reads in name order; the last statement's residual runs on the host.
SQL_PUSHDOWN = [
    ("SELECT COUNT(*) FROM bench WHERE f = 1 AND g = 2",
     "Count(Intersect(Row(f=1), Row(g=2)))", _scalar,
     ("plan_eval",)),
    ("SELECT COUNT(*) FROM bench WHERE v > 5000", "Count(Row(v > 5000))",
     _scalar, ("plan_eval",)),
    ("SELECT COUNT(*) FROM bench WHERE v BETWEEN 100 AND 200",
     "Count(Row(v >< [100, 200]))", _scalar, ("plan_eval",)),
    ("SELECT SUM(v), AVG(v) FROM bench WHERE f = 3",
     "Sum(Row(f=3), field=v) Sum(Row(f=3), field=v)", _sum_avg,
     ("bsi_sum_planes",)),
    ("SELECT MIN(v), MAX(v) FROM bench WHERE g = 2",
     "Min(Row(g=2), field=v) Max(Row(g=2), field=v)",
     _vals, ("bsi_min_max",)),
    ("SELECT PERCENTILE(v, 50) FROM bench", "Percentile(field=v, nth=50)",
     _vals, ("percentile_counts",)),
    ("SELECT VAR(v) FROM bench", "Var(field=v)", _scalar,
     ("var_moments",)),
    ("SELECT CORR(v, u) FROM bench WHERE g = 2",
     "Corr(field=v, field2=u, filter=Row(g=2))", _scalar,
     ("corr_moments",)),
    ("SELECT f, g, COUNT(*) FROM bench GROUP BY f, g",
     "GroupBy(Rows(f), Rows(g))",
     lambda r: [[gc.group[0].row_id, gc.group[1].row_id, gc.count]
                for gc in r[0]], ("pair_counts",)),
    ("SELECT g, SUM(v) FROM bench GROUP BY g",
     "GroupBy(Rows(g), aggregate=Sum(field=v))",
     lambda r: [[gc.group[0].row_id, gc.agg] for gc in r[0]],
     ("bsi_sum_groups",)),
    ("SELECT COUNT(DISTINCT v) FROM bench", "Count(Distinct(field=v))",
     _scalar, ("bsi_decode",)),
    ("SELECT DISTINCT g FROM bench", "Distinct(field=g)",
     lambda r: [[int(c)] for c in r[0].columns()], ("row_counts",)),
    ("SELECT _id, v, u FROM bench WHERE v = 42",
     "Extract(Row(v == 42), Rows(u), Rows(v))",
     lambda r: [[c.column, c.rows[1], c.rows[0]] for c in r[0].columns],
     ("plan_eval", "bsi_decode_gather")),
    ("SELECT _id, v, u FROM bench WHERE v = 42 AND u + 1 > 10",
     "Extract(Row(v == 42), Rows(u), Rows(v))",
     lambda r: [[c.column, c.rows[1], c.rows[0]] for c in r[0].columns
                if c.rows[0] is not None and c.rows[0] + 1 > 10],
     ("plan_eval", "bsi_decode_gather")),
]
# the statements the sql phase times through execute_sql and API.query
SQL_TIMED = [SQL_PUSHDOWN[i] for i in (0, 3, 6, 8, 9, 12)]


def sql_oracle(model: "WriteModel") -> dict:
    """numpy's answers, as SQL rows, to the statements of SQL_PUSHDOWN it
    holds: the counts, SUM and AVG, MIN and MAX, and both GROUP BYs.  The
    GROUP BYs count through one bincount of each record's f and g rows
    packed into a code (at 80 M records a mask a pair takes seconds)."""
    F, G, v, alive = model.F, model.G, model.v, model.alive
    f3, g2 = F[:, 3], G[:, 2]
    s3, n3 = int(v[f3].sum()), int(f3.sum())
    nf, ng = F.shape[1], G.shape[1]
    if nf > 16 or ng > 8:
        raise AssertionError("f's rows must pack into 16 bits, g's into 8")

    def code(bits):   # a record's rows as the bits of one integer
        w = (1 << np.arange(bits.shape[1])).astype(np.uint16)
        return bits.view(np.uint8).astype(np.uint16) @ w
    fcode, gcode = code(F).astype(np.int64), code(G)
    n = np.bincount(fcode << 8 | gcode)
    used = np.flatnonzero(n)
    fr, gr = (used >> 8)[:, None], (used & 255)[:, None]
    pairs = ((fr >> np.arange(nf) & 1)[:, :, None] &
             (gr >> np.arange(ng) & 1)[:, None, :])
    count = np.einsum("k,kfg->fg", n[used], pairs)
    has_c = (np.arange(256)[:, None] >> np.arange(ng) & 1).astype(bool)
    g_n = np.bincount(gcode, minlength=256) @ has_c
    g_sum = np.bincount(gcode, weights=v, minlength=256) @ has_c
    q = [s[0] for s in SQL_PUSHDOWN]
    return {
        q[0]: [[int((F[:, 1] & g2).sum())]],
        q[1]: [[int((alive & (v > 5000)).sum())]],
        q[2]: [[int((alive & (v >= 100) & (v <= 200)).sum())]],
        q[3]: [[s3, s3 / n3 if n3 else None]],
        q[4]: [[int(v[g2].min()), int(v[g2].max())]],
        q[8]: [[r, c, int(count[r, c])] for r in range(nf)
               for c in range(ng) if count[r, c]],
        q[9]: [[c, int(g_sum[c])] for c in range(ng) if g_n[c]],
    }


def sql_writes(model: "WriteModel", rng, n_shards: int, n: int) -> list:
    """The sql phase's writes, as statements, and the model after them: an
    INSERT of n records over every shard (half of them new ids, half live
    records, whose f and g gain a row and whose v and u are replaced; u
    NULL on one in ten, which leaves it as it was), a DELETE of n // 20
    ids (half of them inserted ones) and a DELETE under a pushable filter."""
    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    old = rng.choice(np.flatnonzero(model.alive), n // 2, replace=False)
    # new ids: a shard each in turn, drawn until none is taken (a set of
    # the 80 M taken ids would cost seconds; the table's ids are sorted)
    have = model.cols if np.all(model.cols[1:] > model.cols[:-1]) \
        else np.sort(model.cols)
    new = []
    while len(new) < n - n // 2:
        c = len(new) % n_shards * SHARD_WIDTH + int(rng.integers(
            SHARD_WIDTH))
        at = int(np.searchsorted(have, c))
        if (at == have.size or have[at] != c) and c not in new:
            new.append(c)
    k, m = len(new), model.cols.size
    model.cols = np.concatenate([model.cols, np.array(new, np.int64)])
    model.F = np.concatenate([model.F, np.zeros((k, model.F.shape[1]),
                                                bool)])
    model.G = np.concatenate([model.G, np.zeros((k, model.G.shape[1]),
                                                bool)])
    model.v = np.concatenate([model.v, np.zeros(k, np.int64)])
    model.u = np.concatenate([model.u, np.zeros(k, model.u.dtype)])
    model.u_has = np.concatenate([model.u_has, np.zeros(k, bool)])
    model.alive = np.concatenate([model.alive, np.zeros(k, bool)])
    rows = np.concatenate([old, np.arange(m, m + k)])
    tuples = []
    for i in rows:
        f, g = int(rng.integers(8)), int(rng.integers(model.G.shape[1]))
        v, u = int(rng.integers(-1000, 10001)), int(rng.integers(-500, 4001))
        u_null = rng.random() < 0.1
        model.F[i, f] = model.G[i, g] = model.alive[i] = True
        model.v[i] = v
        if not u_null:
            model.u[i], model.u_has[i] = u, True
        tuples.append(f"({int(model.cols[i])}, {f}, {g}, {v}, "
                      f"{'NULL' if u_null else u})")
    gone = np.concatenate([rng.choice(old, n // 40, replace=False),
                           rng.choice(np.arange(m, m + k), n // 40,
                                      replace=False)])
    filt = model.alive & (model.v >= 4000) & (model.v <= 4010) & \
        model.F[:, 2]
    for dead in (gone, np.flatnonzero(filt)):
        model.F[dead] = model.G[dead] = False
        model.u_has[dead] = model.alive[dead] = False
    return ["INSERT INTO bench (_id, f, g, v, u) VALUES " + ", ".join(tuples),
            "DELETE FROM bench WHERE _id IN (" + ", ".join(
                str(int(model.cols[i])) for i in gone) + ")",
            "DELETE FROM bench WHERE v BETWEEN 4000 AND 4010 AND f = 2"]


# The dialect at small size, drawn from the acceptance corpora
# (tests/test_acceptance_sql*.py, tests/test_sql*.py): each statement after
# those before it; {tmp} is a directory of each API's own.
SQL_DIALECT = [
    "CREATE TABLE dt (_id ID, i INT MIN -100 MAX 1000, d DECIMAL(2), "
    "b BOOL, s STRING, ss STRINGSET, x ID, xs IDSET, ts TIMESTAMP, "
    "tq STRINGSET TIMEQUANTUM 'YMD')",
    "CREATE TABLE kt (_id STRING, grp STRING, score INT MIN 0 MAX 100)",
    "INSERT INTO dt (_id, i, d, b, s, ss, x, xs, ts, tq) VALUES "
    "(1, 10, 1.50, true, 'alpha', ['p', 'q'], 7, [1, 2], "
    "'2023-01-15T10:30:00Z', ['e']), "
    "(2, -5, 2.25, false, 'beta', ['q'], 8, [2], '2024-02-29T12:00:00Z', "
    "['f']), "
    "(3, 300, 0.75, true, 'gamma', ['r'], 7, [3], '2022-12-31T23:59:59Z', "
    "['e']), "
    "(1048577, 42, NULL, NULL, 'delta', NULL, NULL, [1], NULL, NULL)",
    "INSERT INTO kt (_id, grp, score) VALUES ('u1', 'a', 10), "
    "('u2', 'a', 20), ('u3', 'b', 30)",
    "REPLACE INTO kt (_id, grp, score) VALUES ('u2', 'b', 25)",
    "SELECT * FROM dt",
    "SELECT _id, i, d FROM dt WHERE i > 0 ORDER BY i DESC",
    "SELECT COUNT(*), SUM(i), AVG(i), MIN(d), MAX(d) FROM dt",
    "SELECT PERCENTILE(i, 50), VAR(i), COUNT(DISTINCT i) FROM dt",
    "SELECT b, COUNT(*) FROM dt GROUP BY b",
    "SELECT s, SUM(i) FROM dt GROUP BY s HAVING SUM(i) > 0 ORDER BY s",
    "SELECT x, COUNT(*) FROM dt GROUP BY x ORDER BY x",
    "SELECT DISTINCT x FROM dt",
    "SELECT _id FROM dt WHERE ss = 'q'",
    "SELECT _id FROM dt WHERE SETCONTAINS(xs, 2)",
    "SELECT _id FROM dt WHERE s LIKE '%a' AND i IN (10, 42)",
    "SELECT _id FROM dt WHERE d BETWEEN 1.0 AND 3.0",
    "SELECT _id FROM dt WHERE ts > '2023-01-01T00:00:00Z'",
    "SELECT _id FROM dt WHERE i IS NULL OR d IS NULL",
    "SELECT kt._id, dt.s FROM kt INNER JOIN dt ON kt.score = dt.i",
    "SELECT a._id, b._id FROM dt a LEFT JOIN dt b ON a.x = b.i "
    "ORDER BY a._id",
    "SELECT _id FROM dt WHERE i IN (SELECT score FROM kt)",
    "SELECT _id FROM dt WHERE i > (SELECT MIN(score) FROM kt)",
    "SELECT COUNT(*) FROM (SELECT _id FROM dt WHERE i > 0) q",
    "CREATE VIEW pos AS SELECT _id, i FROM dt WHERE i > 0",
    "SELECT * FROM pos ORDER BY i LIMIT 2 OFFSET 1",
    "SELECT grp, COUNT(*), SUM(score) FROM kt GROUP BY grp",
    "SELECT UPPER(s), LEN(s), SUBSTRING(s, 1, 2), REVERSE(s), s || '!' "
    "FROM dt ORDER BY _id",
    "SELECT DATETIMEPART('yy', ts), DATEADD('d', 1, ts) FROM dt "
    "WHERE ts IS NOT NULL ORDER BY _id",
    "SELECT CAST(i AS STRING), CAST(d AS INT), CAST(b AS INT), "
    "CAST('12' AS INT) FROM dt ORDER BY _id",
    "SELECT CASE WHEN i > 100 THEN 'big' ELSE 'small' END, "
    "COALESCE(d, 0) FROM dt ORDER BY _id",
    "SHOW TABLES",
    "SHOW COLUMNS FROM dt",
    "SHOW CREATE TABLE dt",
    "SHOW VIEWS",
    "SELECT name, column_count, shard_count FROM fb_table_info",
    "SELECT name, shard_width FROM fb_database_info",
    "SELECT * FROM fb_table_columns",
    "COPY dt TO '{tmp}/dt.csv'",
    "COPY dt2 FROM '{tmp}/dt.csv'",
    "SELECT * FROM dt2",
    "CREATE TABLE bk (_id ID, n INT MIN 0 MAX 100, s STRING)",
    "BULK INSERT INTO bk (_id, n, s) MAP (0 ID, 1 INT, 2 STRING) "
    "FROM x'1,10,a\n2,20,b\n3,30,a' WITH FORMAT 'CSV' INPUT 'STREAM'",
    "SELECT s, SUM(n) FROM bk GROUP BY s",
    "DELETE FROM dt WHERE s = 'beta'",
    "SELECT _id FROM dt",
    "SELECT * FROM missing_table",
    "SELEKT 1",
    "SELECT sql, status FROM fb_exec_requests WHERE status = 'error'",
]


def sql_plain(rows) -> bool:
    """Every cell a plain int, float, str, bool or None, or a list of
    those (what the HTTP server turns into JSON)."""
    def ok(v):
        return type(v) in (int, float, str, bool, type(None)) or \
            type(v) is list and all(ok(x) for x in v)
    return all(ok(v) for row in rows for v in row)


def sql_dialect(tmp: str) -> dict:
    """SQL_DIALECT on a fresh API on the card and on a fresh
    API(device="cpu"): every answer and every error status equal, and the
    two COPY files equal."""
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.sql.engine import execute_sql
    out = {}
    for name, api in (("cuda", API()), ("cpu", API(device="cpu"))):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        got = []
        for sql in SQL_DIALECT:
            try:
                r = execute_sql(api, sql.replace("{tmp}", d))
                if not sql_plain(r["data"]):
                    raise AssertionError(f"{name}: {sql}: a cell is not "
                                         "plain")
                json.dumps(r)
                got.append((r["schema"], r["data"]))
            except AssertionError:
                raise
            except Exception as e:   # APIError: compared by status
                got.append((type(e).__name__, getattr(e, "status", None)))
        with open(os.path.join(d, "dt.csv"), "rb") as fh:
            out[name] = (got, fh.read())
    for sql, a, b in zip(SQL_DIALECT, out["cuda"][0], out["cpu"][0]):
        if a != b:
            raise AssertionError(f"{sql}: cuda {a!r:.300} != cpu {b!r:.300}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError("COPY dt TO: the files differ")
    return dict(statements=len(SQL_DIALECT),
                errors=sum(1 for g in out["cuda"][0] if isinstance(g[0], str)))


def sql_phase(holder, model: "WriteModel", reps: int) -> None:
    """Phase 5e: SQL (featurebase_tpu_torch.sql.engine.execute_sql) over
    the bench holder on the card.  (1) Each statement of SQL_PUSHDOWN
    beside its PQL counterpart through API.query, each on a fresh API (so
    both start from the same caches), the launch counters set to 0 just
    before each and read just after: equal answers, the same kernels
    launched, among them the kernels it is meant to; the numpy-held ones
    (sql_oracle) equal to the model.  (2) SQL writes (sql_writes: 1,000
    records inserted, two DELETEs), then the numpy-held statements again,
    the first read after the writes beside the cached p50.  (3) The
    dialect on the card and on the CPU (sql_dialect).  (4) The p50 of
    SQL_TIMED through execute_sql and of their counterparts through
    API.query, in turns (the difference is SQL's host cost: parse, plan,
    shaping); then SQL_PUSHDOWN under the profiler."""
    import shutil
    import tempfile

    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.sql.engine import execute_sql
    from featurebase_tpu_torch.storage import residency
    t_phase = time.perf_counter()
    residency.residency().set_budget(0)
    residency.reset()

    def timed(fn) -> tuple:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def launched(fn) -> tuple:
        ck.reset_launches()
        out, ms = timed(fn)
        return out, ck.launches(), ms

    # (1) each statement beside its counterpart
    want = sql_oracle(model)
    per = {}
    for sql, pql, shape, meant in SQL_PUSHDOWN:
        got, l_sql, ms_sql = launched(
            lambda: execute_sql(API(holder=holder), sql)["data"])
        res, l_pql, ms_pql = launched(
            lambda: API(holder=holder).query("bench", pql))
        if shape(res) != got:
            raise AssertionError(f"{sql}: {got!r:.300} != {pql} "
                                 f"{shape(res)!r:.300}")
        if not sql_plain(got):
            raise AssertionError(f"{sql}: a cell is not plain")
        json.dumps(got)
        k_sql = sorted(k for k, n in l_sql.items() if n)
        k_pql = sorted(k for k, n in l_pql.items() if n)
        if k_sql != k_pql or not set(meant) <= set(k_sql):
            raise AssertionError(f"{sql} launched {l_sql}; {pql} "
                                 f"{l_pql}; meant {meant}")
        if sql in want and got != want[sql]:
            raise AssertionError(f"{sql}: {got!r:.300} != numpy "
                                 f"{want[sql]!r:.300}")
        per[sql] = dict(rows=len(got), kernels=k_sql,
                        sql_launches={k: l_sql[k] for k in k_sql},
                        pql_launches={k: l_pql[k] for k in k_pql},
                        cold_sql_ms=ms_sql, cold_pql_ms=ms_pql)
    say("sql_pushdown", nvidia_smi=card_line(), statements=per,
        equal_to_pql=True, equal_to_numpy=sorted(want))

    # (2) writes through SQL on a warm API, then the numpy-held reads
    api = API(holder=holder)
    for sql in want:
        execute_sql(api, sql)
    writes = sql_writes(model, np.random.default_rng(47),
                        len(holder.index("bench").available_shards()), 1000)
    write_ms = [timed(lambda: execute_sql(api, s))[1] for s in writes]
    want = sql_oracle(model)
    first, cached = {}, {}
    for sql, rows_want in want.items():
        got, first[sql] = timed(lambda: execute_sql(api, sql)["data"])
        if got != rows_want:
            raise AssertionError(f"{sql} after the writes: {got!r:.300} "
                                 f"!= numpy {rows_want!r:.300}")
        cached[sql] = float(np.median([timed(
            lambda: execute_sql(api, sql))[1] for _ in range(5)]))
    say("sql_writes", nvidia_smi=card_line(),
        insert_ms=write_ms[0], delete_ids_ms=write_ms[1],
        delete_filter_ms=write_ms[2], records=int(model.alive.sum()),
        first_read_ms=first, cached_p50_ms=cached, equal_to_numpy=True)

    # (3) the dialect, on the card and on the CPU
    tmp = tempfile.mkdtemp(prefix="sql-dialect-",
                           dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        dialect = sql_dialect(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("sql_dialect", cuda_equal_to_cpu=True, **dialect)

    # (4) SQL's host cost, and a profiled pass
    p50 = {}
    for sql, pql, _, _ in SQL_TIMED:
        runs = [(timed(lambda: execute_sql(api, sql))[1],
                 timed(lambda: api.query("bench", pql))[1])
                for _ in range(reps)]
        s, q = (float(np.median([r[i] for r in runs])) for i in (0, 1))
        p50[sql] = dict(sql_p50_ms=s, pql_p50_ms=q, sql_host_ms=s - q,
                        pql=pql)
    say("sql_p50", nvidia_smi=card_line(), reps=reps, statements=p50)
    queries = [s[0] for s in SQL_PUSHDOWN]

    def run_ms(sql) -> float:
        return timed(lambda: execute_sql(api, sql))[1]
    latency = {q: float(np.median([run_ms(q) for _ in range(3)]))
               for q in queries}
    query_profile(queries, run_ms, latency, phase="sql_profile")
    residency.residency().set_budget(0)
    residency.reset()
    say("sql_phase", seconds=time.perf_counter() - t_phase)


def sql_alone(n_shards: int, reps: int) -> None:
    """The sql phase by itself (--only sql): the table, unwritten, then
    sql_phase."""
    holder, gen = build_table(n_shards)
    sql_phase(holder, WriteModel(gen), reps)


# -- the mesh phase -------------------------------------------------------------

MESH_MEMBERS_ONE_CARD = 4   # members on cuda:0 when the machine has one card
MESH_UNEVEN = 125           # the uneven shard list: not a multiple of 4
# every family of the JAX dry run on the bench table, the filtered forms,
# Var and Corr; on a mesh each takes its stacked route (one launch a member)
MESH_QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Row(v > 5000))",
    "Row(f=3)",
    "TopN(f, n=5)",
    "TopN(f, Row(g=2), n=5)",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
    "Min(field=v)",
    "Max(Row(g=2), field=v)",
    "Rows(f)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "Distinct(Row(f=1), field=g)",
    "Distinct(field=v)",
    "Percentile(field=v, nth=50)",
    "Sort(Row(f=1), field=v, limit=10)",
    "Extract(Limit(Row(f=1), limit=1000), Rows(f), Rows(g), Rows(v))",
    "Var(field=v)",
    "Corr(field=v, field2=u, filter=Row(g=2))",
]
# the kernels the mesh pass must launch (kernel A's count, B', C', D', E',
# F', G'', G''', I' and H')
MESH_KERNELS = ("plan_eval", "row_counts", "bsi_sum_planes", "bsi_min_max",
                "pair_counts", "bsi_sum_groups", "bsi_decode",
                "bsi_decode_gather", "percentile_counts", "var_moments",
                "corr_moments")


def mesh_members() -> list:
    """Every card when the machine has two or more, else four members on
    cuda:0 (a member may repeat a device)."""
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n >= 2 else \
        ["cuda:0"] * MESH_MEMBERS_ONE_CARD


def mesh_sync(mesh) -> None:
    for dev in sorted(set(mesh.members), key=str):
        torch.cuda.synchronize(dev)


def multihost_ranks(devices=None, backend=None) -> dict:
    """Two ranks of tests/torch_multihost_worker.py, two members each:
    NCCL with a card each when the machine has two, else Gloo with both
    on cuda:0.  Every rank is joined (killed past its timeout) before the
    outcome is read; each must print its OK line, and each one's share of
    the host bytes must be within 0.15 of its owned share of the 16
    shards."""
    import socket
    root = os.path.dirname(os.path.abspath(__file__))
    if devices is None:
        two = torch.cuda.device_count() >= 2
        backend = "nccl" if two else "gloo"
        devices = ["cuda:0", "cuda:1"] if two else ["cuda:0", "cuda:0"]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests",
                                      "torch_multihost_worker.py"),
         str(port), str(r), "--members", "2", "--device", devices[r],
         "--backend", backend],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    nbytes, owned = {}, {}
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"MULTIHOST_OK {r}" not in out:
            raise AssertionError(f"rank {r} failed (exit {p.returncode}):\n"
                                 f"{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith("MULTIHOST_BYTES"):
                _, wr, b, o = line.split()
                nbytes[int(wr)], owned[int(wr)] = int(b), int(o)
    share = {r: nbytes[r] / sum(nbytes.values()) for r in nbytes}
    owned_share = {r: owned[r] / sum(owned.values()) for r in owned}
    if sum(owned.values()) != 16 or any(
            abs(share[r] - owned_share[r]) >= 0.15 for r in share):
        raise AssertionError(f"host bytes {nbytes} do not follow the owned "
                             f"shards {owned}")
    return dict(backend=backend, devices=devices, seconds=seconds,
                host_bytes=nbytes, owned_shards=owned)


def mesh_phase(holder, reps: int) -> dict:
    """Phase 5f: the mesh (featurebase_tpu_torch.parallel) on the card.
    (a) Executor(holder, mesh=make_mesh(devices=mesh_members())) over
    MESH_QUERIES at every shard of the table, launch counters set to 0
    just before and read just after (every kernel of MESH_KERNELS must
    run), each answer equal to the single-device Executor's on the same
    holder, then again on the uneven list of the first 125 shards; the
    launches of each query a member beside the single device's; each
    query's p50 on the mesh beside the single device's, in turns.  (b) The
    port's dryrun_multichip over the same members.  (c) Two ranks through
    parallel/multihost.py (multihost_ranks).  Returns the mesh pass's
    launches."""
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.model.row import Row
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.parallel.dryrun import dryrun_multichip
    from featurebase_tpu_torch.parallel.mesh import make_mesh
    from featurebase_tpu_torch.storage import residency
    t_phase = time.perf_counter()
    residency.residency().set_budget(0)   # evicts every earlier entry
    residency.reset()
    members = mesh_members()
    mesh = make_mesh(devices=members)
    meshed, single = Executor(holder, mesh=mesh), Executor(holder)
    rank_cache = holder.index("bench").field("f")._topn_cache

    def run(executor, q, shards=None):
        rank_cache.clear()   # TopN counts on the kernel path
        return canon(execute(executor, q, lambda index, pql: executor.execute(
            index, pql, shards)[0]))
    ck.reset_launches()
    t0 = time.perf_counter()
    got = {q: run(meshed, q) for q in MESH_QUERIES}
    mesh_sync(mesh)
    first_s = time.perf_counter() - t0
    launches = ck.launches()
    silent = [k for k in MESH_KERNELS if launches[k] == 0]
    if silent:
        raise AssertionError(f"the mesh pass launched no {silent}: "
                             f"{launches}")
    for q in MESH_QUERIES:
        want = run(single, q)
        if got[q] != want:
            raise AssertionError(f"{q}: mesh {got[q]!r:.200} != one device "
                                 f"{want!r:.200}")
    uneven = list(range(MESH_UNEVEN))
    for q in MESH_QUERIES:
        a, b = run(meshed, q, uneven), run(single, q, uneven)
        if a != b:
            raise AssertionError(f"{q} at {MESH_UNEVEN} shards: mesh "
                                 f"{a!r:.200} != one device {b!r:.200}")

    def launches_of(executor, q) -> dict:
        ck.reset_launches()
        run(executor, q)
        return {k: v for k, v in ck.launches().items() if v}
    per_query = {q: dict(mesh=launches_of(meshed, q),
                         one_device=launches_of(single, q))
                 for q in MESH_QUERIES}

    def timed(executor, q) -> float:
        rank_cache.clear()
        t = time.perf_counter()
        result = execute(executor, q)
        if isinstance(result, Row):
            result.columns()
        mesh_sync(mesh)
        return (time.perf_counter() - t) * 1e3
    p50 = {}
    for q in MESH_QUERIES:
        m, s = [], []
        for _ in range(reps):
            m.append(timed(meshed, q))
            s.append(timed(single, q))
        p50[q] = dict(mesh=float(np.median(m)), one_device=float(np.median(s)))
    a_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    dry = dryrun_multichip(len(members), members)
    dry_s = time.perf_counter() - t0
    ranks = multihost_ranks()
    out = dict(card=card_line(), members=members, shards=len(
        holder.index("bench").available_shards()), uneven=MESH_UNEVEN,
        equal_to_one_device=True, first_pass_s=first_s, launches=launches,
        launches_per_query=per_query, p50_ms=p50, part_a_s=a_s,
        dryrun=dry, dryrun_s=dry_s, multihost=ranks,
        seconds=time.perf_counter() - t_phase)
    say("mesh", **out)
    return launches


def mesh_alone(n_shards: int, reps: int) -> None:
    """The mesh phase by itself (--only mesh): the table, unwritten, then
    mesh_phase."""
    holder, _ = build_table(n_shards)
    mesh_phase(holder, min(reps, 5))


# -- the server phase -----------------------------------------------------------

# bitmap answers wider than this stay in process (the api phase holds them):
# tens of megabytes of JSON over HTTP would time json.dumps, not the server
SERVER_MAX_COLUMNS = 100_000
# the gRPC calls of the phase: SQL statements of SQL_PUSHDOWN (a COUNT, a
# two-field GROUP BY, a scan) and PQL calls (a Count, a TopN, a bitmap of
# 1,000 columns), each unary and streamed
SERVER_GRPC_SQL = [SQL_PUSHDOWN[i][0] for i in (0, 8, 12)]
SERVER_GRPC_PQL = ["Count(Intersect(Row(f=1), Row(g=2)))", "TopN(f, n=5)",
                   "Limit(Row(f=3), limit=1000)"]
# the read mix of the concurrent pass: every kernel of the path, over HTTP
# from SERVER_THREADS threads and over gRPC from as many again
SERVER_READS = [
    "Count(Intersect(Row(f=1), Row(g=2)))", "Count(Row(0 < v < 100))",
    "TopN(f, Row(g=2), n=5)", "Sum(Row(f=1), field=v)",
    "Min(Row(v > 5000), field=v)", "MaxRow(field=f)", "Rows(f)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "Distinct(Row(f=1), field=g)", "Percentile(field=v, nth=50)",
    "Sort(Row(f=1), field=v, limit=10)",
    "Extract(Limit(Row(f=1), limit=1000), Rows(f), Rows(g), Rows(v))",
    "Distinct(Union(Row(g=1), Row(f=null)), field=v)",
    "Var(field=v, filter=Row(f=1))", "Corr(field=v, field2=u)",
    "keyed:Extract(All(), Rows(kf), Rows(n))", "limits:Count(Row(w > 5))"]
SERVER_THREADS = 4
# the wire layer's cost: p50 over HTTP beside API.query, in turns
SERVER_TIMED = ["Count(Intersect(Row(f=1), Row(g=2)))", "Sum(field=v)",
                "Min(field=v)", "TopN(f, n=5)", "GroupBy(Rows(f), Rows(g))",
                "Percentile(field=v, nth=50)", "Var(field=v)",
                "Corr(field=v, field2=u)"]
SERVER_TIMED_RUNS = 5


def jsonable(x):
    """x as it comes back from JSON (tuples as lists, keys as strings)."""
    return json.loads(json.dumps(x))


def too_wide(results: list) -> bool:
    """Whether a result list holds a bitmap wider than SERVER_MAX_COLUMNS
    columns."""
    from featurebase_tpu_torch.model.row import Row
    return any(isinstance(r, Row) and r.count() > SERVER_MAX_COLUMNS
               for r in results)


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def server_child(durable: dict, card: str, device) -> dict:
    """`python -m featurebase_tpu_torch server` as a child process on the
    card over the 16-shard directory api_durability wrote, with token auth
    (an HS256 secret and a permissions file): its start time to /health,
    /status naming the card, DURABLE_READS with an admin token equal to an
    in-process API over the same directory, a reader token that reads and
    whose write is refused (403), nonzero device and host residency bytes
    in /metrics.json.  The child serves from `device`'s kind (--cpu for
    the CPU, where the phase is rehearsed).  It is stopped and joined
    before this returns."""
    import urllib.request

    from featurebase_tpu_torch.client import Client, ClientError
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.server.auth import mint_hs256
    from featurebase_tpu_torch.server.serialize import response_to_json
    root = os.path.dirname(os.path.abspath(__file__))
    d, scratch = durable["dir"], durable["scratch"]
    secret = "chip-smoke-secret"
    perms = os.path.join(scratch, "perms.json")
    with open(perms, "w") as fh:
        json.dump({"user-groups": {"readers": {"bench": "read"}},
                   "admin": "admins"}, fh)
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    log_path = os.path.join(scratch, "server.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "featurebase_tpu_torch", "server",
             "--bind", f"127.0.0.1:{port}", "--data-dir", d,
             "--auth-secret", secret, "--auth-permissions", perms,
             *(["--cpu"] if device.type == "cpu" else [])],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the server exited {proc.returncode}")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("the server did not answer /health "
                                     "within 300 s")
            try:
                urllib.request.urlopen(url + "/health", timeout=2).read()
                break
            except OSError:
                time.sleep(0.1)
        start_s = time.perf_counter() - t0
        admin = Client(url, auth_token=mint_hs256(secret, "ops", ["admins"]))
        reader = Client(url, auth_token=mint_hs256(secret, "reader",
                                                   ["readers"]))
        status = admin.status()
        name = torch.cuda.get_device_name(0)
        if not any(name in dev for dev in status["devices"]):
            raise AssertionError(f"/status does not name {name}: {status}")
        local = API(data_dir=d)
        t1 = time.perf_counter()
        for q in DURABLE_READS:
            got = admin.query(*index_of(q))
            want = jsonable(response_to_json(local.query(*index_of(q))))
            if got != want["results"]:
                raise AssertionError(f"{q}: the child server {got!r:.200} "
                                     f"!= in process {want!r:.200}")
        reads_s = time.perf_counter() - t1
        want = jsonable(response_to_json(local.query("bench",
                                                     "Count(All())")))
        if reader.query("bench", "Count(All())") != want["results"]:
            raise AssertionError("a reader token's read differs")
        try:
            reader.query("bench", "Set(1, f=1)")
            raise AssertionError("a reader token wrote")
        except ClientError as e:
            if e.status != 403:
                raise AssertionError(f"a reader's write answered {e.status}, "
                                     "not 403")
        with urllib.request.urlopen(urllib.request.Request(
                url + "/metrics.json", headers={
                    "Authorization": f"Bearer {admin.auth_token}"}),
                timeout=60) as r:
            metrics = json.loads(r.read())
        hbm, host = (metrics[k]["bytes"] for k in ("hbm_residency",
                                                   "host_residency"))
        if not hbm or not host:
            raise AssertionError(f"/metrics.json residency bytes: device "
                                 f"{hbm}, host {host}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        with open(log_path) as fh:
            log_tail = fh.read()[-2000:]
    return dict(nvidia_smi=card, start_s=start_s, shards=durable["shards"],
                devices=status["devices"], durable_reads=len(DURABLE_READS),
                reads_s=reads_s, equal_to_in_process=True,
                reader_write_status=403, hbm_residency_bytes=hbm,
                host_residency_bytes=host, exit_code=proc.returncode,
                log_tail=log_tail[-300:])


REQUEST_THREAD_ENTRIES = ("process_request_thread (socketserver.py",
                          "_unary_response_in_pool (_server.py",
                          "_stream_response_in_pool (_server.py")


def request_thread_profile(collapsed: str, top: int = 12) -> dict:
    """The samples of the servers' request threads in a collapsed-stack
    profile (utils/profiling.cpu_profile): their count, the share of them
    whose innermost frame is in storage/hostmem.py, and the `top` innermost
    frames with their shares."""
    inner = Counter()
    for line in collapsed.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        stack, n = line.rsplit(" ", 1)
        frames = stack.split(";")
        if any(f.startswith(REQUEST_THREAD_ENTRIES) for f in frames):
            inner[frames[-1]] += int(n)
    total = sum(inner.values())
    if not total:
        raise AssertionError("the profile holds no request thread")
    return dict(request_thread_samples=total,
                hostmem_share=sum(n for f, n in inner.items()
                                  if "(hostmem.py:" in f) / total,
                innermost=[[f, n / total] for f, n in inner.most_common(top)])


def server_phase(holder, queries, durable: dict, reps: int) -> dict:
    """Phase 5g: the server surface (featurebase_tpu_torch.server) on the
    card, over the bench holder as the earlier phases left it.
    (1) Server(api) and GRPCServer(api) on API(holder=holder): the mix over
    POST /index/{i}/query through the port's Client, but for bitmaps wider
    than SERVER_MAX_COLUMNS columns, after a warm pass in process; each
    body equal to response_to_json(api.query_full(...)) in process, the
    launch counters set to 0 around the HTTP pass and around the same
    queries through API.query, equal.  (2) SQL_PUSHDOWN over POST /sql
    equal to execute_sql in process; SERVER_GRPC_SQL over QuerySQLUnary
    and QuerySQL and SERVER_GRPC_PQL over QueryPQLUnary and QueryPQL equal
    to the reference's table form built in process.  (3) SERVER_THREADS
    HTTP client threads and as many gRPC ones run SERVER_READS at once,
    each answer equal to the serial one.  (4) The entry point as a child
    process (server_child).  (5) The p50 of SERVER_TIMED over HTTP beside
    API.query, in turns.  Returns the HTTP pass's launches."""
    import threading

    import grpc

    from featurebase_tpu_torch.client import Client
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.proto import pilosa_pb2 as pb
    from featurebase_tpu_torch.server import grpc_server as gsrv
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.server.http_server import Server
    from featurebase_tpu_torch.server.serialize import response_to_json
    from featurebase_tpu_torch.sql.engine import execute_sql
    from featurebase_tpu_torch.storage import residency
    from featurebase_tpu_torch.utils import profiling
    t_phase = time.perf_counter()
    card = card_line()
    residency.residency().set_budget(0)
    residency.reset()
    api = API(holder=holder)
    srv = Server(api=api).start()
    gs = gsrv.GRPCServer(api=api).start()
    chan = grpc.insecure_channel(gs.address)
    calls = gsrv.make_channel_callables(chan)
    client = Client(srv.url)
    rank_cache = holder.index("bench").field("f")._topn_cache

    def local(q):
        rank_cache.clear()
        return execute(api.executor, q, lambda index, pql: jsonable(
            response_to_json(api.query_full(index, pql)["results"])
        )["results"])

    def wire(q):
        rank_cache.clear()
        return execute(api.executor, q, lambda index, pql: client.query(
            index, pql))
    try:
        # (1) the mix over HTTP
        t0 = time.perf_counter()
        over = []
        for q in queries:
            rank_cache.clear()
            if not too_wide(execute(api.executor, q, lambda index, pql:
                                    api.query_full(index, pql)["results"])):
                over.append(q)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        ck.reset_launches()
        t0 = time.perf_counter()
        http = {q: wire(q) for q in over}
        torch.cuda.synchronize()
        http_s = time.perf_counter() - t0
        http_launches = ck.launches()
        ck.reset_launches()
        t0 = time.perf_counter()
        inproc = {q: local(q) for q in over}
        torch.cuda.synchronize()
        inproc_s = time.perf_counter() - t0
        inproc_launches = ck.launches()
        for q in over:
            if http[q] != inproc[q]:
                raise AssertionError(f"{q}: HTTP {http[q]!r:.200} != in "
                                     f"process {inproc[q]!r:.200}")
        if http_launches != inproc_launches:
            raise AssertionError(f"the HTTP pass launched {http_launches}, "
                                 f"API.query {inproc_launches}")
        silent = [k for k, n in http_launches.items()
                  if n == 0 and k in MESH_KERNELS]
        if silent:
            raise AssertionError(f"the HTTP pass launched no {silent}")
        say("server_http", nvidia_smi=card, queries=len(over),
            in_process_only=[q for q in queries if q not in over],
            equal_to_in_process=True, warm_pass_s=warm_s,
            http_pass_s=http_s, in_process_pass_s=inproc_s,
            launches=http_launches, launches_equal=True)

        # (2) SQL over HTTP; SQL and PQL over gRPC
        for sql, *_ in SQL_PUSHDOWN:
            got, want = client.sql(sql), jsonable(execute_sql(api, sql))
            if got != want:
                raise AssertionError(f"{sql}: HTTP {got!r:.200} != in "
                                     f"process {want!r:.200}")
        grpc_checked = []
        for kind, items, req, rows in (
                ("SQL", SERVER_GRPC_SQL,
                 lambda s: pb.QuerySQLRequest(sql=s),
                 lambda s: gsrv._sql_rows(api, s)),
                ("PQL", SERVER_GRPC_PQL,
                 lambda q: pb.QueryPQLRequest(index="bench", pql=q),
                 lambda q: gsrv._pql_rows(api, "bench", q))):
            for item in items:
                rank_cache.clear()
                unary = calls[f"Query{kind}Unary"](req(item))
                rank_cache.clear()
                stream = list(calls[f"Query{kind}"](req(item)))
                rank_cache.clear()
                want = list(rows(item))
                if unary.SerializeToString() != \
                        gsrv._table(want).SerializeToString() or \
                        [r.SerializeToString() for r in stream] != \
                        [r.SerializeToString() for r in want]:
                    raise AssertionError(f"gRPC {kind} {item}: the reply "
                                         "differs from the table built in "
                                         "process")
                grpc_checked.append((kind, item, len(want)))
        say("server_sql_grpc", nvidia_smi=card,
            sql_over_http=len(SQL_PUSHDOWN), grpc=grpc_checked,
            equal_to_in_process=True)

        # (3) concurrent clients against the serial answers
        def grpc_read(q):
            index, pql = index_of(q)
            return calls["QueryPQLUnary"](pb.QueryPQLRequest(
                index=index, pql=pql)).SerializeToString()
        t0 = time.perf_counter()
        serial_http = {q: client.query(*index_of(q)) for q in SERVER_READS}
        serial_http_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serial_grpc = {q: grpc_read(q) for q in SERVER_READS}
        serial_grpc_s = time.perf_counter() - t0
        errors = []

        def worker(k):
            n = len(SERVER_READS)
            order = SERVER_READS[k % n:] + SERVER_READS[:k % n]
            try:
                for q in order:
                    if k < SERVER_THREADS:
                        ok = client.query(*index_of(q)) == serial_http[q]
                    else:
                        ok = grpc_read(q) == serial_grpc[q]
                    if not ok:
                        errors.append((k, q))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append((k, repr(e)))

        def concurrent_pass(during=lambda: None) -> float:
            """Seconds of one pass of every client thread, `during` run in
            this thread meanwhile."""
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(2 * SERVER_THREADS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            during()
            for t in threads:
                t.join(timeout=600)
            seconds = time.perf_counter() - t0
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"concurrent answers differ from the "
                                     f"serial ones: {errors[:5]}")
            return seconds
        concurrent_s = concurrent_pass()
        say("server_concurrent", nvidia_smi=card, reads=len(SERVER_READS),
            http_threads=SERVER_THREADS, grpc_threads=SERVER_THREADS,
            serial_http_s=serial_http_s, serial_grpc_s=serial_grpc_s,
            concurrent_s=concurrent_s, equal_to_serial=True)
        # the host's profile of a second pass: where the server's request
        # threads are, sampled (utils/profiling.py, the /debug/pprof/profile
        # sampler) while the clients run
        prof = []
        profiled_s = concurrent_pass(lambda: prof.append(
            profiling.cpu_profile(concurrent_s * 0.9)))
        say("server_concurrent_profile", nvidia_smi=card,
            profiled_pass_s=profiled_s, **request_thread_profile(prof[0]))

        # (5) the wire layer's host cost
        def ms(fn) -> float:
            rank_cache.clear()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3
        timed = {}
        for q in SERVER_TIMED:
            runs = [(ms(lambda: client.query("bench", q)),
                     ms(lambda: api.query("bench", q)))
                    for _ in range(SERVER_TIMED_RUNS)]
            h, a = (float(np.median([r[i] for r in runs])) for i in (0, 1))
            timed[q] = dict(http_p50_ms=h, api_p50_ms=a, wire_ms=h - a)
            SERVER_WIRE[q] = h
        say("server_wire_ms", nvidia_smi=card, runs=SERVER_TIMED_RUNS,
            queries=timed)
    finally:
        chan.close()
        gs.stop()
        srv.stop()

    # (4) the entry point as a child process
    try:
        child = server_child(durable, card, api.executor.device)
    finally:
        import shutil
        shutil.rmtree(durable["scratch"], ignore_errors=True)
    say("server_child", **child)
    say("server_phase", nvidia_smi=card,
        seconds=time.perf_counter() - t_phase)
    return http_launches


def server_alone(n_shards: int, reps: int) -> None:
    """The server phase by itself (--only server): the table, unwritten,
    the 16-shard durable directory, then server_phase."""
    holder, gen = build_table(n_shards)
    durable = api_durability(np.random.default_rng(43))
    server_phase(holder, mix_of(gen, n_shards)[0], durable, reps)


# -- the ingest phase (featurebase_tpu_torch.ingest, native/, utils/pool.py)

INGEST_SHARDS = 16          # the bench table's shards reloaded through roaring
DATAGEN_RECORDS = 2_097_152  # two shards of the customer source
DATAGEN_BATCH = 262_144
KAFKA_RECORDS = 262_144     # kitchen-sink records through the broker
KAFKA_BATCH = 65_536
DELTA_RECORDS = 625_000     # one shard's BSI import, 1% of columns twice
POOL_REPS = 5


def pool_queries(queries) -> list:
    """The mix's Count, Sum, Min/Max, GroupBy, Distinct and Sort under the
    filters the plan compiler refuses and the Extracts (per-shard
    fallbacks on the submitting thread), and the Sort past depth 31,
    which hands the worker pool its host jobs."""
    return [q for q in queries
            if ("Row(f=null)" in q
                and not q.startswith(("Options(Var", "Options(Corr")))
            or "Extract(" in q or ("Sort(" in q and "field=w" in q)]


def mirrors_on_device(api, index: str) -> int:
    """The fragment mirrors of `index` held on the API's device (it fails
    when there is none, or one elsewhere)."""
    mirrors = [fr._dev_device for f in api.holder.index(index)
               .fields.values() for v in f.views.values()
               for fr in v.fragments.values() if fr._dev is not None]
    if not mirrors or any(d.type != api.executor.device.type
                          for d in mirrors):
        raise AssertionError(f"{index}: fragment mirrors on {set(mirrors)}")
    return len(mirrors)


def roaring_reload(api, queries, card) -> dict:
    """(a) Every view of every field of INGEST_SHARDS shards of the bench
    index exported through the C++ codec and imported shard by shard into
    a fresh index; the mix over those shards equal on both; one shard's
    payloads equal between the C++ and the Python codec; codec MB/s."""
    from featurebase_tpu_torch.native import roaring
    src = api.holder.index("bench")
    shards = list(range(INGEST_SHARDS))
    api.create_index("reload", src.options.to_json())
    for f in src.public_fields():
        api.create_field("reload", f.name, f.options.to_json())
    views = [(f.name, vname) for f in src.fields.values()
             for vname in f.views]
    t0 = time.perf_counter()
    payloads = {s: {f"{fn}/{vn}": {"data": api.export_roaring(
        "bench", fn, s, view=vn)} for fn, vn in views} for s in shards}
    export_s = time.perf_counter() - t0
    wire = sum(len(p["data"]) for s in shards for p in payloads[s].values())
    t0 = time.perf_counter()
    decoded = [roaring.decode(p["data"]) for s in shards
               for p in payloads[s].values()]
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = [roaring.encode(k, w) for k, w in decoded]
    encode_s = time.perf_counter() - t0
    dense = sum(w.nbytes for _, w in decoded)
    if again != [p["data"] for s in shards for p in payloads[s].values()]:
        raise AssertionError("roaring.encode(decode(x)) != x")
    for spec, p in payloads[0].items():
        keys, words = roaring._decode_py(p["data"])
        k2, w2 = roaring.decode(p["data"])
        if roaring._encode_py(keys, words) != p["data"] or not (
                np.array_equal(keys, k2) and np.array_equal(words, w2)):
            raise AssertionError(f"{spec}: the Python codec differs from "
                                 "the C++ codec")
    t0 = time.perf_counter()
    for s in shards:
        api.import_roaring_shard("reload", s, payloads[s])
    import_s = time.perf_counter() - t0
    del payloads, decoded, again
    records = int(api.query("reload", "Count(All())")[0])
    want = int(api.query("bench", "Count(All())", shards=shards)[0])
    if records != want:
        raise AssertionError(f"reloaded {records} records of {want}")

    def run(index, q):
        return canon(execute(api.executor, q, lambda _, pql: api.query(
            index, pql, shards=shards)[0]))
    mix = [q for q in queries if index_of(q)[0] == "bench"
           and "shards=" not in q]
    for q in mix:
        a, b = run("bench", q), run("reload", q)
        if a != b:
            raise AssertionError(f"{q}: reloaded {b!r:.200} != {a!r:.200}")
    mirrors = mirrors_on_device(api, "reload")
    out = dict(shards=INGEST_SHARDS, views=len(views), records=records,
               queries_equal=len(mix), wire_mb=wire / 1e6,
               dense_mb=dense / 1e6, export_s=export_s,
               import_s=import_s, import_records_per_s=records / import_s,
               decode_mb_per_s=wire / decode_s / 1e6,
               encode_mb_per_s=wire / encode_s / 1e6,
               decode_dense_mb_per_s=dense / decode_s / 1e6,
               mirrors_on_device=mirrors)
    say("ingest_roaring", nvidia_smi=card, **out)
    return out


def datagen_oracle(schema, lo: int, hi: int, batch: int) -> dict:
    """numpy's answers to DATAGEN_QUERIES over generate_batches' arrays."""
    from featurebase_tpu_torch.ingest import datagen
    parts = [c for _, c in datagen.generate_batches(schema, lo, hi, 0, batch)]
    c = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    n = c["age"].size
    interests = np.zeros((24, n), dtype=bool)
    for j in range(c["interests"].shape[1]):
        interests[c["interests"][:, j], np.arange(n)] = True
    per = interests.sum(1)
    top = sorted(((int(per[r]), r) for r in range(24) if per[r]),
                 key=lambda t: (-t[0], t[1]))[:5]
    on = c["active"] == 1
    age = c["age"]
    groups = [((a, b), int(((c["segment"] == a) & (c["region"] == b)).sum()))
              for a in range(5) for b in range(5)]
    return {
        "Count(Row(segment=1))": ("value", int((c["segment"] == 1).sum())),
        "TopN(interests, n=5)": ("pairs", [(r, k) for k, r in top]),
        "Sum(Row(active=1), field=spend)":
            ("valcount", (int(c["spend"][on].sum()), int(on.sum()))),
        "Min(field=age)": ("valcount", (int(age.min()),
                                        int((age == age.min()).sum()))),
        "Max(field=age)": ("valcount", (int(age.max()),
                                        int((age == age.max()).sum()))),
        "GroupBy(Rows(segment), Rows(region))":
            ("list", [(g, k, 0) for g, k in groups if k])}


def datagen_load(card) -> dict:
    """(b) datagen's customer source, DATAGEN_RECORDS records, into a card
    API and a CPU API: their answers equal, and equal to numpy's."""
    from featurebase_tpu_torch.ingest import datagen
    from featurebase_tpu_torch.server.api import API
    hi = DATAGEN_RECORDS - 1
    oracle = datagen_oracle(datagen.resolve_source("customer"), 0, hi,
                            DATAGEN_BATCH)
    out = {}
    for where, api in (("cuda", API()), ("cpu", API(device="cpu"))):
        t0 = time.perf_counter()
        n = datagen.load_index(api, "cust", "customer", 0, hi, seed=0,
                               batch_size=DATAGEN_BATCH)
        load_s = time.perf_counter() - t0
        if n != DATAGEN_RECORDS or api.available_shards("cust") != [0, 1]:
            raise AssertionError(f"datagen loaded {n} records")
        for q, want in oracle.items():
            got = canon(api.query("cust", q)[0])
            if got != want:
                raise AssertionError(f"datagen {where} {q}: {got!r:.200} "
                                     f"!= numpy {want!r:.200}")
        out[where] = dict(load_s=load_s, records_per_s=n / load_s)
        del api
    say("ingest_datagen", nvidia_smi=card, records=DATAGEN_RECORDS,
        queries_equal=sorted(oracle), **out)
    return out


KAFKA_QUERIES = ["Count(All())", "TopN(s)", "Count(Row(m=3))",
                 "Count(Row(b=1))", "Sum(field=i)", "Min(field=i)",
                 "Max(field=i)", "Sum(field=d)", "Max(field=d)",
                 "Min(field=ts)", "Count(Row(i > 990))",
                 "GroupBy(Rows(m), Rows(b))", "Sum(Row(s=3), field=d)",
                 "MinRow(field=s)", "MaxRow(field=m)",
                 "Sum(Row(s=null), field=i)"]


def kafka_ingest(card) -> dict:
    """(c) KAFKA_RECORDS kitchen-sink records onto the port's in-process
    broker (load_kafka), consumed by the Ingester into a durable card API
    that crashes once after an import and before its commit and resumes
    from its directory: every record once, the answers equal to
    load_index of the same records."""
    import shutil
    import tempfile

    from featurebase_tpu_torch.ingest import datagen
    from featurebase_tpu_torch.ingest.idk import Ingester
    from featurebase_tpu_torch.ingest.kafka_broker import KafkaBroker
    from featurebase_tpu_torch.ingest.kafka_source import (KafkaClient,
                                                           KafkaSource)
    from featurebase_tpu_torch.server.api import API
    scratch = tempfile.mkdtemp(prefix="ingest-kafka-",
                               dir=os.path.dirname(os.path.abspath(__file__)))
    broker = KafkaBroker(num_partitions=1,
                         offsets_path=os.path.join(scratch, "offsets.json"))
    broker.start()
    try:
        c = KafkaClient("127.0.0.1", broker.port)
        c.negotiate()
        t0 = time.perf_counter()
        n = datagen.load_kafka(c, "ks", "kitchen-sink", 0,
                               KAFKA_RECORDS - 1, seed=5,
                               batch_size=KAFKA_BATCH)
        produce_s = time.perf_counter() - t0
        c.close()
        d = os.path.join(scratch, "node")
        schema = datagen.resolve_source("kitchen-sink")
        api = API(data_dir=d)
        datagen.ensure_schema(api, "k", schema)
        src = KafkaSource(f"127.0.0.1:{broker.port}", "ks", group="chip")
        ing = Ingester(api, "k", src, batch_size=KAFKA_BATCH)

        class Crash(Exception):
            pass

        def crash(batch_no):
            if batch_no == 1:
                raise Crash()
        ing._post_import_hook = crash
        t0 = time.perf_counter()
        try:
            ing.run()
            raise AssertionError("the injected crash did not happen")
        except Crash:
            pass
        committed = src.checkpoint()
        del api, ing
        api = API(data_dir=d)         # restart: snapshot, then the WAL
        src = KafkaSource(f"127.0.0.1:{broker.port}", "ks", group="chip")
        stats = Ingester(api, "k", src, batch_size=KAFKA_BATCH).run()
        consume_s = time.perf_counter() - t0
        if stats["records"] != KAFKA_RECORDS - committed:
            raise AssertionError(f"the resumed ingester read {stats}")
        direct = API()
        datagen.load_index(direct, "k", "kitchen-sink", 0,
                           KAFKA_RECORDS - 1, seed=5,
                           batch_size=KAFKA_BATCH)
        for q in KAFKA_QUERIES:
            a, b = canon(api.query("k", q)[0]), canon(direct.query("k", q)[0])
            if a != b:
                raise AssertionError(f"kafka {q}: {a!r:.200} != load_index "
                                     f"{b!r:.200}")
        if api.query("k", "Count(All())")[0] != KAFKA_RECORDS:
            raise AssertionError("records lost or doubled")
        mirrors = mirrors_on_device(api, "k")
    finally:
        broker.stop()
        shutil.rmtree(scratch, ignore_errors=True)
    out = dict(records=n, produce_s=produce_s,
               produce_records_per_s=n / produce_s, consume_s=consume_s,
               consume_records_per_s=KAFKA_RECORDS / consume_s,
               crash_after_batch=1, committed_at_crash=committed,
               batches=stats["batches"] + 2,
               queries_equal=KAFKA_QUERIES, mirrors_on_device=mirrors)
    say("ingest_kafka", nvidia_smi=card, **out)
    return out


def device_delta(card, dev=None) -> dict:
    """(d) One shard's BSI import delta of DELTA_RECORDS records with 1%
    of the columns given twice: Field._bsi_delta with
    FEATUREBASE_TPU_DEVICE_INGEST=1 builds it on the card (the tile's
    device seen) equal to the host OR at depths 14 and 31, and takes the
    host OR at depth 32; both timed."""
    from featurebase_tpu_torch.model.field import Field
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.server.api import API
    rng = np.random.default_rng(17)
    api = API()
    dev = dev or api.executor.device
    seen = []
    real = bsiops.bsi_delta_device

    def spy(cols, mags, neg, depth):
        tile = real(cols, mags, neg, depth)
        seen.append(tile.device)
        return tile
    bsiops.bsi_delta_device = spy
    old = os.environ.get("FEATUREBASE_TPU_DEVICE_INGEST")
    out = {}
    try:
        for depth in (14, 31, 32):
            cols = rng.choice(1 << 20, DELTA_RECORDS, replace=False)
            cols = np.concatenate([cols, cols[: DELTA_RECORDS // 100]])
            hi = (1 << depth) - 1
            vals = rng.integers(-hi, hi + 1, cols.size)
            mags = np.abs(vals).astype(np.uint64)
            os.environ.pop("FEATUREBASE_TPU_DEVICE_INGEST", None)
            t0 = time.perf_counter()
            host = Field._bsi_delta(cols, vals, mags, depth)
            host_ms = (time.perf_counter() - t0) * 1e3
            os.environ["FEATUREBASE_TPU_DEVICE_INGEST"] = "1"
            del seen[:]
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = Field._bsi_delta(cols, vals, mags, depth, dev)
                runs.append((time.perf_counter() - t0) * 1e3)
            if depth <= 31:
                if len(seen) != 3 or any(d.type != dev.type for d in seen):
                    raise AssertionError(f"depth {depth}: delta on {seen}")
                if not np.array_equal(got, host):
                    raise AssertionError(f"depth {depth}: the device delta "
                                         "differs from the host OR")
                out[f"d{depth}"] = dict(device_ms=float(np.median(runs)),
                                        host_ms=host_ms,
                                        tile_device=str(seen[0]))
            else:
                if seen:
                    raise AssertionError("depth 32 did not take the host OR")
                out["d32"] = dict(host_path=True, ms=float(np.median(runs)),
                                  host_ms=host_ms)
        # through a card API: the values land from the device delta
        api.create_index("dd")
        api.create_field("dd", "v", {"type": "int"})
        cols = rng.choice(1 << 20, DELTA_RECORDS, replace=False)
        vals = rng.integers(-9999, 10000, cols.size)
        del seen[:]
        api.import_values("dd", "v", cols, vals)
        if [d.type for d in seen] != [dev.type]:
            raise AssertionError(f"the API's import built its delta on "
                                 f"{seen}")
        got = canon(api.query("dd", "Sum(field=v)")[0])
        if got != ("valcount", (int(vals.sum()), int(cols.size))):
            raise AssertionError(f"device-ingested Sum {got}")
    finally:
        bsiops.bsi_delta_device = real
        if old is None:
            os.environ.pop("FEATUREBASE_TPU_DEVICE_INGEST", None)
        else:
            os.environ["FEATUREBASE_TPU_DEVICE_INGEST"] = old
    say("ingest_bsi_delta", nvidia_smi=card, records=DELTA_RECORDS,
        duplicated=DELTA_RECORDS // 100, **out)
    return out


def pool_turns(api, queries, card) -> dict:
    """(e) The per-shard fallbacks with the worker pool and with a serial
    map patched into the executor module, in turns: answers equal, p50s."""
    from featurebase_tpu_torch.executor import executor as exmod
    pooled = exmod.map_shards

    def serial(fn, items):
        return [fn(it) for it in items]

    def timed(q):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = canon(execute(api.executor, q,
                          lambda index, pql: api.query(index, pql)[0]))
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3
    out = {}
    try:
        for q in pool_queries(queries):
            ms = {"pool": [], "serial": []}
            answers = set()
            for _ in range(POOL_REPS):
                for mode, fn in (("pool", pooled), ("serial", serial)):
                    exmod.map_shards = fn
                    r, t = timed(q)
                    answers.add(json.dumps(r))
                    ms[mode].append(t)
            if len(answers) != 1:
                raise AssertionError(f"{q}: the pool and the serial map "
                                     "answer differently")
            out[q] = {f"{m}_p50_ms": float(np.median(v[1:]))
                      for m, v in ms.items()}
    finally:
        exmod.map_shards = pooled
    say("ingest_pool", nvidia_smi=card, reps=POOL_REPS - 1, queries=out)
    return out


def roaring_http(api, card) -> dict:
    """(e) One shard of field f over HTTP: POST its roaring payload to
    /index/rt/field/f/import-roaring/0, GET /export back: the bytes equal
    the in-process export, and the counts equal the bench index's."""
    import urllib.request

    from featurebase_tpu_torch.server.http_server import Server
    data = api.export_roaring("bench", "f", 0)
    api.create_index("rt")
    api.create_field("rt", "f", {"type": "set"})
    srv = Server(api=api).start()
    try:
        req = urllib.request.Request(
            srv.url + "/index/rt/field/f/import-roaring/0", data=data,
            method="POST", headers={"Content-Type":
                                    "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()
        with urllib.request.urlopen(
                srv.url + "/export?index=rt&field=f&shard=0",
                timeout=120) as r:
            back = r.read()
    finally:
        srv.stop()
    if back != data or back != api.export_roaring("rt", "f", 0):
        raise AssertionError("the HTTP roaring round trip changed the bytes")
    for r in range(8):
        a = api.query("rt", f"Count(Row(f={r}))")
        b = api.query("bench", f"Count(Row(f={r}))", shards=[0])
        if a != b:
            raise AssertionError(f"row {r}: {a} != {b}")
    out = dict(bytes=len(data), equal=True)
    say("ingest_http", nvidia_smi=card, **out)
    return out


def ingest_phase(holder, queries) -> dict:
    """Phase 5h: ingest on the card (see the module docstring); returns
    the launches of its reads."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.server.api import API
    t_phase = time.perf_counter()
    card = card_line()
    ck.reset_launches()
    api = API(holder=holder)
    roaring_reload(api, queries, card)
    pool_turns(api, queries, card)
    roaring_http(api, card)
    api.delete_index("reload")
    api.delete_index("rt")
    datagen_load(card)
    kafka_ingest(card)
    device_delta(card)
    launches = ck.launches()
    say("ingest_phase", nvidia_smi=card, launches=launches,
        seconds=time.perf_counter() - t_phase)
    return launches


def ingest_alone(n_shards: int, reps: int) -> None:
    """The ingest phase by itself (--only ingest): the table, unwritten,
    then ingest_phase."""
    holder, gen = build_table(n_shards)
    del reps
    ingest_phase(holder, mix_of(gen, n_shards)[0])


# -- the cluster phase ------------------------------------------------------

CLUSTER_NODES = 3
CLUSTER_REPLICAS = 2
SERVER_WIRE: dict = {}   # the server phase's HTTP p50 (ms) of SERVER_TIMED
CLUSTER_P50: dict = {}   # the cluster phase's HTTP p50 (ms) of SERVER_TIMED
# the families of the cluster parity tests (tests/torch_cluster_data.py)
# over the bench index: through node 0's HTTP, each answer equal to the
# single device's over the same holder
CLUSTER_QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=3)))",
    "Count(Row(v > 5000))",
    "Row(f=3)",
    "TopN(f, n=5)",
    "TopN(f, Row(g=2), n=5)",
    "TopK(f, k=3)",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
    "Min(field=v)",
    "Max(Row(g=2), field=v)",
    "MinRow(field=f)",
    "MaxRow(field=f)",
    "Rows(f)",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "GroupBy(Rows(f), Rows(g), having=Condition(count > 2500000))",
    "GroupBy(Rows(f), Rows(g), limit=5)",
    "Distinct(Row(f=1), field=g)",
    "Count(Distinct(field=v))",
    "Percentile(field=v, nth=50)",
    "Percentile(field=v, nth=99.9, filter=Row(f=1))",
    "Sort(Row(f=1), field=v, limit=10)",
    "Sort(Row(v == 42), field=v)",
    "Extract(Row(v == 42), Rows(v), Rows(g))",
    "Extract(Limit(Row(f=1), limit=1000), Rows(f), Rows(g), Rows(v))",
    "Count(Limit(Row(f=2), limit=5000))",
    "Var(field=v)",
    "Var(field=v, filter=Row(f=1))",
    "Corr(field=v, field2=u)",
    "IncludesColumn(Row(f=1), column={col5})",
    "FieldValue(field=v, column={col5})",
    'Apply(Intersect(Row(f=1), Row(g=2)), "v * 2 + u", "sum")',
    "Arrow(Row(f=1))",
]
# answered again by the surviving replicas after node 2 stops
CLUSTER_FAILOVER = ["Count(Intersect(Row(f=1), Row(g=2)))", "TopN(f, n=5)",
                    "Sum(field=v)", "GroupBy(Rows(f), Rows(g))"]
CLUSTER_WIRE = "Row(f=3)"    # the bitmap result whose partials are measured
CLUSTER_KEYS = 40            # records of the keyed index ("ckeyed")
# the CLI deployment: three `server --cluster-nodes` processes over the
# first CLI_SHARDS shards of the bench index, and one fresh `server` that a
# backup of them is restored into
CLI_SHARDS = 16
CLI_QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=2)))", "TopN(f, n=5)", "Sum(field=v)",
    "Min(field=v)", "MaxRow(field=f)", "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), aggregate=Sum(field=v))",
    "Distinct(Row(f=1), field=g)", "Percentile(field=v, nth=50)",
    "Sort(Row(f=1), field=v, limit=10)",
    "Extract(Row(v == 42), Rows(v), Rows(g))", "Var(field=v)",
    "Corr(field=v, field2=u)",
]
CLUSTER_KERNELS = ("plan_eval", "row_counts", "bsi_sum_planes",
                   "bsi_min_max", "pair_counts", "bsi_sum_groups",
                   "bsi_decode", "bsi_decode_gather", "percentile_counts",
                   "var_moments", "corr_moments")


def http_json(url: str, method: str, path: str, body=None, timeout=300):
    import urllib.request
    req = urllib.request.Request(
        url + path, method=method,
        data=json.dumps(body).encode() if body is not None else None)
    req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else {}


def bench_views(src) -> list:
    """(field, view) of every view of the bench index, _exists included."""
    return [(f.name, vn) for f in src.fields.values() for vn in f.views]


def shard_payload(src, views, shard: int) -> dict:
    """One shard's views as roaring payloads (ingest/roaring_import.py
    export_roaring, the C++ codec), for import_roaring_shard."""
    from featurebase_tpu_torch.ingest.roaring_import import export_roaring
    return {f"{fn}/{vn}": {"data": export_roaring(src, fn, shard, view=vn)}
            for fn, vn in views}


def cli_nodes_start(device, scratch: str) -> dict:
    """The CLI deployment's processes, started at once: CLUSTER_NODES
    `python -m featurebase_tpu_torch server --cluster-nodes ...` (replicas
    CLUSTER_REPLICAS) and one plain `server`, the restore's fresh node;
    each on `device`'s kind (--cpu on the CPU, where it is rehearsed)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    ports = [free_port() for _ in range(CLUSTER_NODES + 1)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    spec = ",".join(f"node{i}={u}" for i, u in enumerate(urls[:-1]))
    cpu = ["--cpu"] if device.type == "cpu" else []
    procs, logs = [], []
    for i, port in enumerate(ports):
        argv = [sys.executable, "-m", "featurebase_tpu_torch", "server",
                "--bind", f"127.0.0.1:{port}", *cpu]
        if i < CLUSTER_NODES:
            argv += ["--cluster-nodes", spec, "--name", f"node{i}",
                     "--replicas", str(CLUSTER_REPLICAS)]
        logs.append(os.path.join(scratch, f"node{i}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(argv, cwd=root, env=env,
                                          stdout=log,
                                          stderr=subprocess.STDOUT))
    ch = dict(procs=procs, urls=urls, logs=logs, scratch=scratch,
              t0=time.perf_counter(), ready_s={})

    def watch():
        """Each process's seconds to its first /health answer."""
        import urllib.request
        for i, (url, proc) in enumerate(zip(urls, procs)):
            while proc.poll() is None and \
                    time.perf_counter() - ch["t0"] < 300:
                try:
                    urllib.request.urlopen(url + "/health", timeout=2).read()
                    ch["ready_s"][f"node{i}"] = \
                        time.perf_counter() - ch["t0"]
                    break
                except OSError:
                    time.sleep(0.1)
    import threading
    ch["watch"] = threading.Thread(target=watch, daemon=True)
    ch["watch"].start()
    return ch


def cli_nodes_stop(ch: dict) -> list:
    """Stop and join the CLI deployment's processes; their exit codes."""
    for p in ch["procs"]:
        if p.poll() is None:
            p.terminate()
    codes = []
    for p in ch["procs"]:
        try:
            codes.append(p.wait(timeout=60))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def cli_cluster(ch: dict, holder, single, card: str) -> dict:
    """(b) The CLI deployment (cli_nodes_start's processes): CLI_SHARDS
    shards of the bench index loaded through node 0's HTTP roaring import
    (forwarded to their owners), CLI_QUERIES through node 0 and node 2
    equal to the single device's over those shards; then `backup --host`
    of node 0 and `restore --host` into the fresh node, whose answers are
    the same."""
    import contextlib
    import io

    from featurebase_tpu_torch import cli
    from featurebase_tpu_torch.server.serialize import response_to_json
    urls = ch["urls"]
    ch["watch"].join(timeout=max(1.0, 300 - (time.perf_counter() - ch["t0"])))
    for i, (proc, log) in enumerate(zip(ch["procs"], ch["logs"])):
        if f"node{i}" not in ch["ready_s"]:
            with open(log) as fh:
                raise AssertionError(
                    f"CLI node {i} did not answer /health (exit "
                    f"{proc.poll()}):\n{fh.read()[-2000:]}")
    ready_s = ch["ready_s"]
    src = holder.index("bench")
    shards = list(range(CLI_SHARDS))
    node0 = urls[0]
    t0 = time.perf_counter()
    http_json(node0, "POST", "/index/cli", {"options": src.options.to_json()})
    for f in src.public_fields():
        http_json(node0, "POST", f"/index/cli/field/{f.name}",
                  {"options": f.options.to_json()})
    import base64
    views = bench_views(src)
    for s in shards:
        body = {"views": {spec: {"data": base64.b64encode(
            p["data"]).decode("ascii")} for spec, p in shard_payload(
                src, views, s).items()}}
        http_json(node0, "POST", f"/index/cli/shard/{s}/import-roaring",
                  body)
    load_s = time.perf_counter() - t0
    rank_cache = src.field("f")._topn_cache

    def want_of(q):
        rank_cache.clear()
        return jsonable(response_to_json(single.execute("bench", q,
                                                        shards=shards)))
    want = {q: want_of(q) for q in CLI_QUERIES}

    def check(url, what):
        t = time.perf_counter()
        for q in CLI_QUERIES:
            got = http_json(url, "POST", "/index/cli/query", {"query": q})
            if got != want[q]:
                raise AssertionError(f"{what} {q}: {got!r:.200} != the "
                                     f"single device {want[q]!r:.200}")
        return time.perf_counter() - t
    cluster_s = check(node0, "CLI cluster node 0")
    node2_s = check(urls[2], "CLI cluster node 2")
    tar = os.path.join(ch["scratch"], "cli-backup.tgz")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["backup", "--host", node0, "--output", tar])
    backup_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"backup exited {rc}: {out.getvalue()}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["restore", "--host", urls[-1], "--source", tar])
    restore_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"restore exited {rc}: {out.getvalue()}")
    restored_s = check(urls[-1], "the restored node")
    status = http_json(node0, "GET", "/status")
    if status.get("state") != "NORMAL" or len(status.get("nodes", [])) \
            != CLUSTER_NODES:
        raise AssertionError(f"the CLI cluster's /status: {status}")
    return dict(nodes=CLUSTER_NODES, replicas=CLUSTER_REPLICAS,
                shards=CLI_SHARDS, ready_s=ready_s, load_s=load_s,
                queries=len(CLI_QUERIES), node0_s=cluster_s, node2_s=node2_s,
                backup_s=backup_s, backup_bytes=os.path.getsize(tar),
                restore_s=restore_s, restored_s=restored_s,
                equal_to_single_device=True, devices=status["devices"],
                cli_output=out.getvalue().strip().splitlines())


def cluster_answers(holder, single) -> tuple:
    """CLUSTER_QUERIES with a record of shard 5 as {col5} (mix_of's) and
    Arrow only where the api phase left the bench index a dataframe, and
    the single device's JSON answer to each."""
    from featurebase_tpu_torch.server.serialize import response_to_json
    src = holder.index("bench")
    shards = src.available_shards()
    col5 = int(single.execute("bench", "Limit(All(), limit=1)",
                              shards=[min(5, shards[-1])])[0].columns()[0])
    queries = [q.replace("{col5}", str(col5)) for q in CLUSTER_QUERIES
               if not q.startswith("Arrow") or src.dataframe.shards]
    rank_cache = src.field("f")._topn_cache

    def one(q):
        rank_cache.clear()
        return jsonable(response_to_json(single.execute("bench", q)))
    return queries, {q: one(q) for q in queries}


def cluster_phase(holder, reps: int) -> dict:
    """Phase 5i: the cluster (featurebase_tpu_torch.cluster) on the card.
    (a) TestCluster(CLUSTER_NODES, replicas=CLUSTER_REPLICAS), in process,
    each node an API on the card: the bench index loaded through node 0's
    API.import_roaring_shard, a call a shard, from the holder's roaring
    export (the payloads forwarded over HTTP to their owners);
    CLUSTER_QUERIES through node 0's HTTP, each equal to the single
    device's answer over the holder, the first pass with each node's legs
    one at a time under its launch counters (every kernel must rise), then
    SERVER_TIMED's p50 of `reps` runs (5 past 200 ms) beside the server
    phase's single-node HTTP p50; the wire cost of CLUSTER_WIRE's
    partials; a keyed index written and read through its key's partition
    primary, the key on every node; node 2 stopped and CLUSTER_FAILOVER
    answered by the surviving replicas (the first pass after the failover
    timed); a Set through node 1 read back from both owners of its shard;
    the device bytes held.  (b) The CLI deployment (cli_cluster), whose
    processes start first.  Returns the first pass's launches, summed
    over the nodes, and what the dax phase takes from this one: the
    queries, the single device's answers and each shard's roaring
    payloads."""
    import tempfile
    import threading

    from featurebase_tpu_torch.cluster.wire import (decode_result,
                                                    encode_call)
    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.pql.parser import parse
    from featurebase_tpu_torch.storage import residency
    from featurebase_tpu_torch.testing import TestCluster
    t_phase = time.perf_counter()
    card = card_line()
    scratch = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    residency.residency().set_budget(0)
    residency.reset()
    single = Executor(holder)
    ch = cli_nodes_start(single.device, scratch)
    tc = None
    try:
        src = holder.index("bench")
        shards = src.available_shards()
        t0 = time.perf_counter()
        queries, want = cluster_answers(holder, single)
        single_s = time.perf_counter() - t0
        tc = TestCluster(CLUSTER_NODES, replicas=CLUSTER_REPLICAS)
        t0 = time.perf_counter()
        tc.http(0, "POST", "/index/bench", {"options": src.options.to_json()})
        for f in src.public_fields():
            tc.http(0, "POST", f"/index/bench/field/{f.name}",
                    {"options": f.options.to_json()})
        views = bench_views(src)
        t1 = time.perf_counter()
        payloads = {s: shard_payload(src, views, s) for s in shards}
        export_s = time.perf_counter() - t1
        wire = sum(len(p["data"]) for pl in payloads.values()
                   for p in pl.values())
        for s in shards:
            tc[0].import_roaring_shard("bench", s, payloads[s])
        load_s = time.perf_counter() - t0
        for api in tc.apis:   # the holder's dataframe shards, for Arrow
            api.holder.index("bench").dataframe.shards.update(
                src.dataframe.shards)
        held = {n.id: sum(1 for s in shards if tc[0].cluster.snapshot
                          .owns_shard(n.id, "bench", s))
                for n in tc[0].cluster.nodes}

        # the first pass: each node's legs one at a time under the launch
        # counters, so that each launch is charged to its node
        per_node = {f"node{i}": Counter() for i in range(CLUSTER_NODES)}
        lock = threading.Lock()

        def counted(api, name):
            orig = api.query_remote_local

            def leg(index, query, leg_shards):
                with lock:
                    before = ck.launches()
                    out = orig(index, query, leg_shards)
                    torch.cuda.synchronize()
                    after = ck.launches()
                per_node[name].update({k: after[k] - before[k]
                                       for k in after})
                return out
            return leg
        for i, api in enumerate(tc.apis):
            api.query_remote_local = counted(api, f"node{i}")
        first = {}
        try:
            for q in queries:
                t1 = time.perf_counter()
                got = tc.query(0, "bench", q)
                first[q] = (time.perf_counter() - t1) * 1e3
                if got != want[q]:
                    raise AssertionError(f"cluster {q}: {got!r:.200} != the "
                                         f"single device {want[q]!r:.200}")
        finally:
            for api in tc.apis:
                del api.query_remote_local
        launches = Counter()
        for c in per_node.values():
            launches.update(c)
        missing = [k for k in CLUSTER_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"the cluster's nodes did not launch "
                                 f"{missing}: {dict(per_node)}")
        resident_first = residency.residency().stats()
        for q in CLUSTER_FAILOVER:
            if tc.query(1, "bench", q) != want[q]:
                raise AssertionError(f"cluster node 1 {q} differs")

        def timed(q) -> float:
            t1 = time.perf_counter()
            tc.query(0, "bench", q)
            return (time.perf_counter() - t1) * 1e3

        def p50(q) -> float:
            head = timed(q)
            n = reps if head < 200 else 5
            return float(np.median([head] + [timed(q)
                                             for _ in range(n - 1)]))
        t0 = time.perf_counter()
        latency = {q: p50(q) for q in SERVER_TIMED}
        latency_s = time.perf_counter() - t0
        CLUSTER_P50.update(latency)

        # the wire cost of a bitmap's partials: each node's partial of
        # CLUSTER_WIRE over the shards it serves, encoded, its JSON bytes,
        # and decoded as the coordinator decodes it
        dx = tc[0].distributed
        groups = dx._group_shards("bench", shards)
        call = parse(CLUSTER_WIRE).calls[0]
        partials = {}
        for nid, node_shards in sorted(groups.items()):
            api = tc[int(nid[4:])]
            t1 = time.perf_counter()
            enc = api.query_remote("bench", [encode_call(call)], node_shards)
            enc_ms = (time.perf_counter() - t1) * 1e3
            body = json.dumps({"partials": enc})
            t1 = time.perf_counter()
            row = decode_result(json.loads(body)["partials"][0])
            dec_ms = (time.perf_counter() - t1) * 1e3
            partials[nid] = dict(shards=len(node_shards),
                                 columns=int(row.count()),
                                 json_mb=len(body) / 1e6, encode_ms=enc_ms,
                                 decode_ms=dec_ms)

        # a keyed index: a write through its key's partition primary, read
        # there and held against a single-device API's same writes
        keyed = keyed_cluster(tc, single.device)

        # failover: node 2 stops; the surviving replicas answer
        tc.stop_node(2)
        after = {}
        for q in CLUSTER_FAILOVER:
            t1 = time.perf_counter()
            got = tc.query(0, "bench", q)
            after[q] = (time.perf_counter() - t1) * 1e3
            if got != want[q]:
                raise AssertionError(f"after the failover {q}: {got!r:.200} "
                                     f"!= {want[q]!r:.200}")
        after_p50 = {q: float(np.median([timed(q) for _ in range(5)]))
                     for q in CLUSTER_FAILOVER}
        resident_failover = residency.residency().stats()

        # a replicated write: a Set through node 1 into a shard of nodes 0
        # and 1, read back from both owners' own holders
        snap = tc[0].cluster.snapshot
        shard = next(s for s in range(1 << 16) if {
            n.id for n in snap.shard_nodes("bench", s)} == {"node0",
                                                             "node1"})
        col = shard * SHARD_WIDTH + 12345
        if tc.query(1, "bench", f"Set({col}, f=20)") != {"results": [True]}:
            raise AssertionError("the replicated Set did not change a bit")
        for n in ("node0", "node1"):
            got = tc[int(n[4:])].executor.execute(
                "bench", "Count(Row(f=20))", shards=[shard])
            if got != [1]:
                raise AssertionError(f"{n} does not hold the replicated "
                                     f"write: {got}")
        out = dict(
            nodes=CLUSTER_NODES, replicas=CLUSTER_REPLICAS,
            shards=len(shards), shards_held=held, load_s=load_s,
            export_s=export_s, payload_mb=wire / 1e6,
            single_device_s=single_s, queries=len(queries),
            equal_to_single_device=True, first_pass_ms=first,
            p50_ms=latency, latency_s=latency_s,
            server_wire_p50_ms={q: SERVER_WIRE[q] for q in SERVER_TIMED
                                if q in SERVER_WIRE},
            launches_by_node={k: dict(v) for k, v in per_node.items()},
            wire=dict(query=CLUSTER_WIRE, partials=partials),
            keyed=keyed, failover_first_ms=after,
            failover_p50_ms=after_p50, replicated_write=dict(
                shard=shard, column=col, read_back_from=["node0", "node1"]),
            residency_bytes=dict(first_pass=resident_first["bytes"],
                                 after_failover=resident_failover["bytes"]))
        say("cluster_in_process", nvidia_smi=card, **out)
        tc.close()
        tc = None
        cli = cli_cluster(ch, holder, single, card)
        say("cluster_cli", nvidia_smi=card, **cli)
    finally:
        if tc is not None:
            tc.close()
        codes = cli_nodes_stop(ch)
        import shutil
        shutil.rmtree(scratch, ignore_errors=True)
    launches = {k: launches[k] for k in ck.launches()}
    say("cluster_phase", nvidia_smi=card, launches=launches,
        cli_exit_codes=codes, seconds=time.perf_counter() - t_phase)
    return launches, dict(queries=queries, want=want, payloads=payloads,
                          single_device_s=single_s)


def keyed_cluster(tc, device) -> dict:
    """The keyed index "ckeyed" (CLUSTER_KEYS records with string keys, a
    keyed set field kf, an int field n) created and imported through node
    0, and through a single-device API; a Set of a new record key through
    the node that is its key partition's primary, then reads through that
    node equal to the single device's, and the new key's id the same on
    every node."""
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.server.serialize import response_to_json
    rng = np.random.default_rng(7)
    keys = [f"rec-{i}" for i in range(CLUSTER_KEYS)]
    colors = [["alpha", "beta", "gamma"][i]
              for i in rng.integers(0, 3, CLUSTER_KEYS)]
    vals = [int(x) for x in rng.integers(0, 1000, CLUSTER_KEYS)]
    ref = API(device=device)
    schema = [("POST", "/index/ckeyed", {"options": {"keys": True}}),
              ("POST", "/index/ckeyed/field/kf",
               {"options": {"type": "set", "keys": True}}),
              ("POST", "/index/ckeyed/field/n",
               {"options": {"type": "int", "min": 0, "max": 1000}})]
    for m, p, b in schema:
        tc.http(0, m, p, b)
    ref.create_index("ckeyed", {"keys": True})
    ref.create_field("ckeyed", "kf", {"type": "set", "keys": True})
    ref.create_field("ckeyed", "n", {"type": "int", "min": 0, "max": 1000})
    tc.http(0, "POST", "/index/ckeyed/field/kf/import",
            {"rowKeys": colors, "columnKeys": keys})
    tc.http(0, "POST", "/index/ckeyed/field/n/import",
            {"values": vals, "columnKeys": keys})
    ref.import_bits("ckeyed", "kf", None, None, row_keys=colors,
                    col_keys=keys)
    ref.import_values("ckeyed", "n", None, vals, col_keys=keys)
    new = "cluster-new-key"
    primary = tc[0].cluster.snapshot.primary_key_node("ckeyed", new)
    p = int(primary.id[4:])
    write = f'Set("{new}", kf="alpha")'
    got = tc.query(p, "ckeyed", write)
    want = jsonable(response_to_json(ref.query("ckeyed", write)))
    if got != want:
        raise AssertionError(f"keyed {write}: {got} != {want}")
    reads = ['Row(kf="alpha")', "Count(All())", "Distinct(field=kf)",
             "Extract(All(), Rows(kf), Rows(n))", "Sort(All(), field=n, "
             "limit=3)", "TopN(kf, n=2)"]
    for q in reads:
        got = tc.query(p, "ckeyed", q)
        want = jsonable(response_to_json(ref.query("ckeyed", q)))
        if got != want:
            raise AssertionError(f"keyed {q} through the primary: "
                                 f"{got!r:.200} != {want!r:.200}")
    ids = {f"node{i}": api.holder.index("ckeyed").translate_store
           .find_keys([new]).get(new) for i, api in enumerate(tc.apis)}
    if len(set(ids.values())) != 1 or None in ids.values():
        raise AssertionError(f"the new key's ids on the nodes: {ids}")
    return dict(records=CLUSTER_KEYS, primary=primary.id, key_ids=ids,
                reads=len(reads), equal_to_single_device=True)


def cluster_alone(n_shards: int, reps: int) -> None:
    """The cluster phase by itself (--only cluster): the table, unwritten,
    then cluster_phase."""
    holder, _ = build_table(n_shards)
    cluster_phase(holder, reps)


# -- the dax phase ----------------------------------------------------------

DAX_COMPUTERS = 2
DAX_POLL_S = 0.2    # the controller's poll interval: how soon a stop is seen
DAX_SHARDS = 16     # the shards of the CLI child, restarted cold after it
# the child's writes: a PQL Set of a new row, and a roaring import that
# replaces row f=1 of shard DAX_REPLACED by three columns
DAX_SET = "Set({col}, f=20)"
DAX_REPLACED = 5
DAX_RESTART_READS = ["Sum(field=v)", "Count(Row(f=2))",
                     "Percentile(field=v, nth=50)", "TopN(g)"]
DAX_CLI_QUERIES = CLI_QUERIES[:6]


def dir_mb(path: str) -> float:
    """The MB of the files under `path`."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def dax_cli_start(device, scratch: str) -> dict:
    """`python -m featurebase_tpu_torch dax` as a child process (--cpu on
    the CPU, where it is rehearsed), over its own data directory, started
    at once; a thread waits for its queryer's /health."""
    import threading
    import urllib.request
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    argv = [sys.executable, "-m", "featurebase_tpu_torch", "dax",
            "--computers", str(DAX_COMPUTERS), "--data-dir",
            os.path.join(scratch, "cli"), "--bind", f"127.0.0.1:{port}"]
    if device.type == "cpu":
        argv.append("--cpu")
    log = os.path.join(scratch, "dax-cli.log")
    with open(log, "w") as fh:
        proc = subprocess.Popen(argv, cwd=root, env=env, stdout=fh,
                                stderr=subprocess.STDOUT)
    ch = dict(proc=proc, url=url, log=log, t0=time.perf_counter())

    def watch():
        while proc.poll() is None and time.perf_counter() - ch["t0"] < 300:
            try:
                urllib.request.urlopen(url + "/health", timeout=2).read()
                ch["ready_s"] = time.perf_counter() - ch["t0"]
                return
            except OSError:
                time.sleep(0.1)
    ch["watch"] = threading.Thread(target=watch, daemon=True)
    ch["watch"].start()
    return ch


def dax_cli(ch: dict, holder, single, payloads: dict) -> dict:
    """The DAX child (dax_cli_start): DAX_SHARDS shards of the bench index
    loaded into its index "cli" through its queryer's HTTP roaring import,
    DAX_CLI_QUERIES equal to the single device's over those shards; then
    through the same queryer a PQL Set (DAX_SET) and a roaring import
    that replaces row f=1 of shard DAX_REPLACED by three columns (what
    dax_restart reads back)."""
    import base64

    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    from featurebase_tpu_torch.ingest.roaring_import import \
        payload_from_rows
    from featurebase_tpu_torch.server.serialize import response_to_json
    ch["watch"].join(timeout=max(1.0, 300 - (time.perf_counter() - ch["t0"])))
    if "ready_s" not in ch:
        with open(ch["log"]) as fh:
            raise AssertionError(f"the dax child did not answer /health "
                                 f"(exit {ch['proc'].poll()}):\n"
                                 f"{fh.read()[-2000:]}")
    with open(ch["log"]) as fh:
        ready = fh.readline().strip()
    if not ready.startswith("featurebase_tpu_torch dax: controller="):
        raise AssertionError(f"the dax child's first line: {ready!r}")
    src, url = holder.index("bench"), ch["url"]
    shards = list(range(DAX_SHARDS))
    t0 = time.perf_counter()
    http_json(url, "POST", "/index/cli", {"options": src.options.to_json()})
    for f in src.public_fields():
        http_json(url, "POST", f"/index/cli/field/{f.name}",
                  {"options": f.options.to_json()})
    for s in shards:
        http_json(url, "POST", f"/index/cli/shard/{s}/import-roaring",
                  {"views": {spec: {"data": base64.b64encode(
                      p["data"]).decode("ascii")}
                      for spec, p in payloads[s].items()}})
    load_s = time.perf_counter() - t0
    rank_cache = src.field("f")._topn_cache
    t0 = time.perf_counter()
    for q in DAX_CLI_QUERIES:
        rank_cache.clear()
        want = jsonable(response_to_json(single.execute("bench", q,
                                                        shards=shards)))
        got = http_json(url, "POST", "/index/cli/query", {"query": q})
        if got != want:
            raise AssertionError(f"the dax child {q}: {got!r:.200} != the "
                                 f"single device {want!r:.200}")
    queries_s = time.perf_counter() - t0
    write = DAX_SET.format(col=3 * SHARD_WIDTH + 12345)
    got = http_json(url, "POST", "/index/cli/query", {"query": write})
    if got != {"results": [True]}:
        raise AssertionError(f"the DAX Set answered {got}")
    words = np.zeros(SHARD_WIDTH // 32, dtype=np.uint32)
    words[0] = 0b1110   # columns 1, 2 and 3 of the shard
    http_json(url, "POST", f"/index/cli/shard/{DAX_REPLACED}/import-roaring",
              {"views": {"f/standard": {"data": base64.b64encode(
                  payload_from_rows({1: words})).decode("ascii"),
                  "replace": True}}})
    return dict(ready_s=ch["ready_s"], ready_line=ready, shards=DAX_SHARDS,
                load_s=load_s, queries=len(DAX_CLI_QUERIES),
                queries_s=queries_s, equal_to_single_device=True,
                writes=[write, f"replace f=1 of shard {DAX_REPLACED}"])


def dax_phase(holder, reps: int, shared: dict) -> dict:
    """Phase 5j: DAX (featurebase_tpu_torch.dax) on the card: (a)
    DaxService(DAX_COMPUTERS), each computer and the queryer an API on
    the card, its writelogger and snapshotter in a temporary directory;
    (b) the bench index loaded through the queryer's import_roaring_shard,
    a call a shard, from the cluster phase's roaring payloads (`shared`),
    each computer logging its imports; (c) the cluster phase's queries
    through the queryer's HTTP, each equal to the single device's answer,
    the first pass with each computer's legs one at a time under the
    launch counters (every kernel must rise); (d) SERVER_TIMED's p50
    (runs_for) beside the cluster phase's and the server phase's single
    node's; (e) /dax/snapshot on every computer, timed, with the MB
    written; (f) computer 1 stopped: the seconds until the poller has
    moved its shards to computer 0 and every CLUSTER_FAILOVER answer is
    equal again (the time to recover); (g) a computer added: the seconds
    until it holds its share, the answers unchanged, and no device copy
    left on computer 0 of the shards it gave up; (i) `python -m
    featurebase_tpu_torch dax` as a child started with the phase
    (dax_cli), DAX_SHARDS shards through its queryer, and (h) a PQL Set
    and a roaring replace import through it, read back after the child is
    stopped by a service started cold over its directory (dax_restart);
    the child joined before the processes check; (j) the device bytes
    held.  Returns the first pass's launches, summed over the
    computers."""
    import shutil
    import tempfile
    import threading

    from featurebase_tpu_torch.dax.service import DaxService
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.storage import residency
    t_phase = time.perf_counter()
    card = card_line()
    scratch = tempfile.mkdtemp(prefix="chip-smoke-dax-")
    single = Executor(holder)
    ch = dax_cli_start(single.device, scratch)
    svc = None
    try:
        src = holder.index("bench")
        payloads, queries, want = (shared["payloads"], shared["queries"],
                                   shared["want"])
        shards = sorted(payloads)
        data_dir = os.path.join(scratch, "dax")
        t0 = time.perf_counter()
        svc = DaxService(DAX_COMPUTERS, data_dir=data_dir,
                         poll_interval=DAX_POLL_S, device=single.device)
        start_s = time.perf_counter() - t0
        url = svc.queryer_server.url

        def ask(q):
            return http_json(url, "POST", "/index/bench/query", {"query": q})
        t0 = time.perf_counter()
        http_json(url, "POST", "/index/bench",
                  {"options": src.options.to_json()})
        for f in src.public_fields():
            http_json(url, "POST", f"/index/bench/field/{f.name}",
                      {"options": f.options.to_json()})
        for s in shards:
            svc.queryer.import_roaring_shard("bench", s, payloads[s])
        load_s = time.perf_counter() - t0
        owner = {s: c for c in svc.computers for _, s in c.owned}
        for s, frame in src.dataframe.shards.items():   # Arrow's rows
            owner[s].dataframe_ingest("bench", s, columns={
                k: v.tolist() for k, v in frame.columns.items()})
        log_mb = dir_mb(os.path.join(data_dir, "writelogger"))
        held = {c.worker_id: len(c.owned) for c in svc.computers}

        # (c) the first pass: each computer's legs one at a time under the
        # launch counters, so that each launch is charged to its computer
        per = {c.worker_id: Counter() for c in svc.computers}
        lock = threading.Lock()

        def counted(c):
            orig = c.query_remote_local

            def leg(index, query, leg_shards):
                with lock:
                    before = ck.launches()
                    out = orig(index, query, leg_shards)
                    torch.cuda.synchronize()
                    after = ck.launches()
                per[c.worker_id].update({k: after[k] - before[k]
                                         for k in after})
                return out
            return leg
        for c in svc.computers:
            c.query_remote_local = counted(c)
        first = {}
        try:
            for q in queries:
                t1 = time.perf_counter()
                got = ask(q)
                first[q] = (time.perf_counter() - t1) * 1e3
                if got != want[q]:
                    raise AssertionError(f"dax {q}: {got!r:.200} != the "
                                         f"single device {want[q]!r:.200}")
        finally:
            for c in svc.computers:
                del c.query_remote_local
        launches = Counter()
        for c in per.values():
            launches.update(c)
        missing = [k for k in CLUSTER_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"the computers did not launch {missing}: "
                                 f"{dict(per)}")
        resident_first = residency.residency().stats()["bytes"]

        # (d) p50 through the queryer
        def timed(q) -> float:
            t1 = time.perf_counter()
            ask(q)
            return (time.perf_counter() - t1) * 1e3

        def p50(q) -> float:
            head = timed(q)
            return float(np.median([head] + [timed(q) for _ in range(
                runs_for(head, reps) - 1)]))
        latency = {q: p50(q) for q in SERVER_TIMED}

        # (e) every computer's snapshot of its shards
        snaps = os.path.join(data_dir, "snapshotter")
        snapshot_s = {}
        for c, srv in zip(svc.computers, svc.computer_servers):
            t1 = time.perf_counter()
            http_json(srv.url, "POST", "/dax/snapshot", {})
            snapshot_s[c.worker_id] = time.perf_counter() - t1
        snapshot_mb = dir_mb(snaps)
        log_after_mb = dir_mb(os.path.join(data_dir, "writelogger"))

        # (f) failover: computer 1 stops; the poller moves its shards to
        # computer 0, which loads them from the snapshots and the logs
        everything = {("bench", s) for s in shards}
        c0 = svc.computers[0]
        t0 = time.perf_counter()
        svc.stop_computer(1)
        while not everything <= c0.owned:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("computer 0 did not take computer 1's "
                                     "shards in 120 s")
            time.sleep(0.01)
        moved_s = time.perf_counter() - t0
        svc.queryer.cluster.clear_down()
        for q in CLUSTER_FAILOVER:
            got = ask(q)
            if got != want[q]:
                raise AssertionError(f"dax after the stop {q}: "
                                     f"{got!r:.200} != {want[q]!r:.200}")
        recover_s = time.perf_counter() - t0
        resident_failover = residency.residency().stats()["bytes"]

        # (g) scale-out: a computer joins and takes its share of the shards
        frags = {s: [fr for f in c0.holder.index("bench").fields.values()
                     for v in f.views.values()
                     if (fr := v.fragments.get(s)) is not None]
                 for s in shards}
        t0 = time.perf_counter()
        new = svc.add_computer()
        while len(new.owned) < len(shards) // 2 or \
                not everything <= c0.owned | new.owned or \
                c0.owned & new.owned:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("the new computer did not take its "
                                     "share in 120 s")
            time.sleep(0.01)
        taken_s = time.perf_counter() - t0
        svc.queryer.cluster.clear_down()
        for q in CLUSTER_FAILOVER:
            if ask(q) != want[q]:
                raise AssertionError(f"dax after the scale-out {q} differs")
        scale_s = time.perf_counter() - t0
        gone = [s for _, s in new.owned]
        kept_mirrors = sum(fr._dev is not None for s in gone
                           for fr in frags[s])
        if kept_mirrors:
            raise AssertionError(f"computer 0 keeps {kept_mirrors} device "
                                 "mirrors of the shards it gave up")
        resident_scaled = residency.residency().stats()["bytes"]
        out = dict(
            computers=DAX_COMPUTERS, shards=len(shards), shards_held=held,
            start_s=start_s, load_s=load_s, writelog_mb=log_mb,
            queries=len(queries), equal_to_single_device=True,
            first_pass_ms=first, launches_by_computer={
                k: dict(v) for k, v in per.items()},
            p50_ms=latency, cluster_p50_ms=dict(CLUSTER_P50),
            server_wire_p50_ms={q: SERVER_WIRE[q] for q in SERVER_TIMED
                                if q in SERVER_WIRE},
            snapshot_s=snapshot_s, snapshot_mb=snapshot_mb,
            writelog_after_snapshot_mb=log_after_mb,
            failover=dict(moved_s=moved_s, recover_s=recover_s,
                          shards_moved=len(shards) - held["computer0"]),
            scale_out=dict(taken_s=taken_s, equal_s=scale_s,
                           shards_taken=len(gone), mirrors_left=0),
            residency_bytes=dict(first_pass=resident_first,
                                 after_failover=resident_failover,
                                 after_scale_out=resident_scaled),
            device_bytes=torch.cuda.memory_allocated()
            if single.device.type == "cuda" else None)
        say("dax_in_process", nvidia_smi=card, **out)
        svc.close()
        svc = None

        # (i) the child; (h) the writes it took read back after its stop,
        # by a service started cold over its directory
        cli = dax_cli(ch, holder, single, payloads)
        code = dax_cli_stop(ch)
        if code not in (0, -signal.SIGTERM):
            raise AssertionError(f"the dax child exited {code}")
        restart = dax_restart(os.path.join(scratch, "cli"), holder, single)
        say("dax_durable", nvidia_smi=card, cli=cli, cli_exit_code=code,
            restart=restart)
    finally:
        if svc is not None:
            svc.close()
        dax_cli_stop(ch)
        shutil.rmtree(scratch, ignore_errors=True)
    launches = {k: launches[k] for k in ck.launches()}
    say("dax_phase", nvidia_smi=card, launches=launches,
        seconds=time.perf_counter() - t_phase)
    return launches


def dax_cli_stop(ch: dict) -> int:
    """Stop (SIGTERM) and join the dax child; its exit code."""
    if ch["proc"].poll() is None:
        ch["proc"].terminate()
    try:
        return ch["proc"].wait(timeout=60)
    except subprocess.TimeoutExpired:
        ch["proc"].kill()
        return ch["proc"].wait()


def dax_restart(data_dir: str, holder, single) -> dict:
    """A DaxService(DAX_COMPUTERS) started cold over the directory the
    stopped dax child wrote: the seconds until its computers hold the
    DAX_SHARDS shards; the child's Set and replaced row read back; and
    DAX_RESTART_READS equal to the single device's over those shards."""
    from featurebase_tpu_torch.dax.service import DaxService
    from featurebase_tpu_torch.server.serialize import response_to_json
    few = list(range(DAX_SHARDS))
    rank_cache = holder.index("bench").field("f")._topn_cache

    def single_of(q, on):
        rank_cache.clear()
        return single.execute("bench", q, shards=on)[0]
    f1 = single_of("Count(Row(f=1))", [s for s in few
                                       if s != DAX_REPLACED]) + 3
    t0 = time.perf_counter()
    with DaxService(DAX_COMPUTERS, data_dir=data_dir,
                    poll_interval=DAX_POLL_S, device=single.device) as svc:
        want = {("cli", s) for s in few}
        while not want <= set().union(*(c.owned for c in svc.computers)):
            if time.perf_counter() - t0 > 120:
                raise AssertionError("the restarted service did not load "
                                     "its shards in 120 s")
            time.sleep(0.01)
        restart_s = time.perf_counter() - t0
        read = {q: svc.queryer.query("cli", q)[0]
                for q in ("Count(Row(f=20))", "Count(Row(f=1))")}
        if read != {"Count(Row(f=20))": 1, "Count(Row(f=1))": f1}:
            raise AssertionError(f"after the restart: {read}, not the Set "
                                 f"and the replaced row ({f1})")
        for q in DAX_RESTART_READS:
            rank_cache.clear()
            w = jsonable(response_to_json(single.execute("bench", q,
                                                         shards=few)))
            got = jsonable(response_to_json(svc.queryer.query("cli", q)))
            if got != w:
                raise AssertionError(f"after the restart {q}: {got!r:.200} "
                                     f"!= {w!r:.200}")
    return dict(shards=DAX_SHARDS, restart_s=restart_s,
                writes_read_back=read, reads=len(DAX_RESTART_READS),
                equal_to_single_device=True)


def dax_alone(n_shards: int, reps: int) -> None:
    """The dax phase by itself (--only dax): the table, unwritten, its
    roaring payloads and the single device's answers as the cluster phase
    makes them, then dax_phase."""
    from featurebase_tpu_torch.executor.executor import Executor
    holder, _ = build_table(n_shards)
    src = holder.index("bench")
    queries, want = cluster_answers(holder, Executor(holder))
    views = bench_views(src)
    dax_phase(holder, reps, dict(
        queries=queries, want=want,
        payloads={s: shard_payload(src, views, s)
                  for s in src.available_shards()}))


# The device symbol of a wrapper's kernel where it is not `<wrapper>_kernel`:
# the forms of kernel H' are moments_kernel<fields, ...>.
KERNEL_SYMBOLS = {"var_moments": "moments_kernel<1,",
                  "corr_moments": "moments_kernel<2,"}


PROFILE_WARM = 3   # queries run under the profiler before the measured pass


def query_profile(queries, timed, latency,
                  phase: str = "query_profile") -> dict:
    """The query mix under one torch.profiler window, each query under a
    record_function label: a warm-up of its first PROFILE_WARM queries
    (the profiler's own start; the callers' caches are warm from their
    latency passes), then the measured pass.  Device
    work belongs to a query through the profiler's launch correlation (the
    runtime call under its label), not through device timestamps, which do
    not line up with the host's.  Per query:
    kernel A, kernel B and all device time, the busy share of its label's
    span (it ends in a synchronize), and the kernels the profiler linked
    against the launch counters; then the pass's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    counted = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, q in enumerate(queries[:PROFILE_WARM]):
            with record_function(f"warm:{i}"):
                timed(q)
        for i, q in enumerate(queries):
            before = ck.launches()
            with record_function(f"query:{i}"):
                timed(q)
            after = ck.launches()
            counted[q] = {k: after[k] - before[k] for k in after}

    # A device event and the runtime call that launched it (cudaLaunchKernel,
    # cudaMemcpyAsync, ...) share a correlation id; the call lies in its
    # query's label span on the host clock.
    events = list(prof.events())
    labels = {int(e.name.split(":")[1]): e.time_range for e in events
              if e.name.startswith("query:")
              and e.device_type == DeviceType.CPU}   # not the device's copy
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.id in calls]
    per, dev_total, span_total = {}, 0.0, 0.0
    for i, q in enumerate(queries):
        span = labels[i]
        ks = [e for e in device if span.start <= calls[e.id] <= span.end]
        by_kernel = {k: [e.time_range.elapsed_us() for e in ks
                         if KERNEL_SYMBOLS.get(k, f"{k}_kernel") in e.name]
                     for k in counted[q]}
        busy = sum(e.time_range.elapsed_us() for e in ks)
        span_us = span.elapsed_us()
        per[q] = dict(
            p50_ms=latency[q], span_ms=span_us / 1e3,
            kernel_us={k: sum(v) for k, v in by_kernel.items() if v},
            device_us=busy, busy_share=busy / span_us,
            kernels_seen={k: len(v) for k, v in by_kernel.items()},
            launches=counted[q])
        dev_total += busy
        span_total += span_us
    missed = {q: r["launches"] for q, r in per.items()
              if r["kernels_seen"] != r["launches"]}
    say(phase, queries=per, pass_span_ms=span_total / 1e3,
        pass_device_ms=dev_total / 1e3, pass_busy_share=dev_total / span_total,
        launches_not_linked_by_profiler=missed)
    return per


def main() -> int:
    global RECORDS_PER_SHARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--log", help="also write every status line to this "
                    "file (the end of standard output may be all a remote "
                    "runner keeps)")
    ap.add_argument("--records-per-shard", type=int,
                    default=RECORDS_PER_SHARD,
                    help="records a shard of the bench table")
    ap.add_argument("--cpu-answers", metavar="PATH",
                    help="run as CPUWorker's worker process: pickle the CPU "
                    "executor's answers to the mix to PATH (no card used)")
    ap.add_argument("--only", choices=["api", "sql", "mesh", "server",
                                       "ingest", "cluster", "dax"],
                    help="run one phase by itself after the card's line: "
                    "the table, then the api, the sql, the mesh, the "
                    "server, the ingest, the cluster or the dax phase (its "
                    "kernels build at first use)")
    args = ap.parse_args()
    RECORDS_PER_SHARD = args.records_per_shard
    if args.cpu_answers:
        cpu_answers(args.shards, args.cpu_answers)
        return 0
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)),
                    exist_ok=True)
        LOG.append(open(args.log, "w"))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import featurebase_tpu_torch  # noqa: F401 — fails at once outside the repo

    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        max_sm_clock_mhz=max_sm_clock_hz() / 1e6, numpy=np.__version__,
        host_cpus=os.cpu_count(), torch_threads=torch.get_num_threads())
    if args.only:
        {"api": api_alone, "sql": sql_alone, "mesh": mesh_alone,
         "server": server_alone, "ingest": ingest_alone,
         "cluster": cluster_alone, "dax": dax_alone}[args.only](
             args.shards, args.reps)
        print(card)
        return 0
    worker = CPUWorker(args.shards)
    try:
        return full_run(args, card, worker)
    finally:
        worker.close()


def full_run(args, card: str, worker: "CPUWorker") -> int:
    """Every phase, in order (main without --only)."""
    from featurebase_tpu_torch.ops import build
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.ops import tune_kernels as tk
    from featurebase_tpu_torch.tools import tune_count_kernel as harness
    lap("card")
    t0 = time.perf_counter()
    sources = (ck.SOURCE, ck.BSI_SOURCE, ck.GROUP_SOURCE, ck.MOMENTS_SOURCE,
               ck.DECODE_SOURCE, tk.SOURCE)
    builds = [*((src, ()) for src in sources),
              *((src, f) for src in (ck.SOURCE, ck.GROUP_SOURCE,
                                     ck.MOMENTS_SOURCE)
                for f in ABLATIONS.values()),
              (ck.SOURCE, ROW_ABLATION), (ck.DECODE_SOURCE, PCT_ABLATION)]
    procs = [(src, f, build.compile_source(src, f)) for src, f in builds]
    probe = build.compile_source(WGMMA_PROBE_SOURCE)
    for src, f, proc in procs:
        build.finish(src, proc, f)
    try:
        build.finish(WGMMA_PROBE_SOURCE, probe)
        WGMMA_PROBE.update(taken=True)
    except RuntimeError as e:   # a finding for tc_rate, not a failure
        WGMMA_PROBE.update(taken=False, log=str(e))
    report = {src: ptxas_report(build.build_log.get(src, ""))
              for src in sources}
    say("build", seconds=time.perf_counter() - t0, ptxas=report)
    lap("build")
    for src in (ck.SOURCE, ck.BSI_SOURCE, ck.GROUP_SOURCE, ck.MOMENTS_SOURCE,
                ck.DECODE_SOURCE):
        whole = src in (ck.GROUP_SOURCE, ck.MOMENTS_SOURCE, ck.DECODE_SOURCE)
        if whole and not report[src]:
            raise AssertionError(f"no ptxas report for {src}")
        for fn, r in report[src].items():
            if ("plan_eval_kernel" in fn or "row_counts_kernel" in fn
                    or "bsi_" in fn or whole) and (
                    r["spill_stores"] or r["spill_loads"]
                    or r["stack_bytes"]):
                raise AssertionError(f"ptxas spills or keeps a stack frame "
                                     f"in {fn}: {r}")
    tune_sass_check()

    S, depth, R = args.shards, 14, 8
    errs, inputs = kernel_parity(S, depth, R)
    bsi_errs, inputs["bsi"] = bsi_parity(S)
    errs.update(bsi_errs)
    errs.update(group_parity())
    errs.update(moments_parity(S))
    decode_errs, decode_inputs = decode_parity(S)
    errs.update(decode_errs)
    lap("parity")
    with worker.stopped():   # the kernels timed on an idle host
        timer = Timer(args.reps)
        times, copy_bps = kernel_times(timer, inputs)
        rates = tc_rate(args.reps, popc_rate(args.reps))
        rate = rates["bit_products_per_s"]
        times.update(group_times(timer, rate, args.reps))
        moments_plans(S)
        times.update(moments_times(timer, rate, args.reps, S))
        times.update(decode_times(timer, decode_inputs, args.reps))
        lap("kernel_times")
        pct_ablation(decode_inputs, args.reps)
        del decode_inputs
        ablation(inputs, args.reps)
        row_ablation(inputs, args.reps)
        group_ablation(args.reps)
        moments_ablation(args.reps, S)
        small = (inputs["a"].reshape(-1), inputs["b"].reshape(-1))
        del inputs
        lap("ablations")
    launches = slice_phase(args.shards, args.reps, worker)
    big = harness.make_inputs(harness.CUDA_BYTES, torch.device("cuda"))
    errs.update(tune_parity({
        "harness": big, "SxW": small,
        "odd": tuple(x[:1000003] for x in small),
        "tiny": tuple(x[:37] for x in small)}))
    tune_launches, tune_times, read_bps = tune_phase(
        timer, big, small, copy_bps, times["plan_eval/and_count"])
    del big
    say("bsi_vs_ceilings", read_ceiling_gb_per_s=read_bps / 1e9, kernels={
        k: dict(ms=times[k]["ms"], device_ms=times[k]["device_ms"],
                bound_ms=times[k]["bound_ms"],
                read_ceiling_ms=times[k]["bytes"] / read_bps * 1e3)
        for k in ("bsi_sum_planes/d14", "bsi_min_max/d14")})
    lap("tune")
    left = child_pids()
    say("processes", children_left=left)
    if left:
        raise AssertionError(f"processes {left} started by this run are "
                             "still running")

    kernels = []
    for name, key, source, replaces in (
            ("plan_eval", "plan_eval/bsi_gt_count", ck.SOURCE,
             "featurebase_tpu/ops/pallas_kernels.py:136"),
            ("row_counts", "row_counts/filtered", ck.SOURCE,
             "featurebase_tpu/ops/pallas_kernels.py:173, "
             "featurebase_tpu/ops/pallas_kernels.py:204"),
            ("bsi_sum_planes", "bsi_sum_planes/d14", ck.BSI_SOURCE,
             "featurebase_tpu/ops/bsi.py:378"),
            ("bsi_min_max", "bsi_min_max/d14", ck.BSI_SOURCE,
             "featurebase_tpu/ops/bsi.py:399"),
            ("pair_counts", "pair_counts/sharded_s128_f8_r4", ck.GROUP_SOURCE,
             "featurebase_tpu/ops/bitwise.py:175, "
             "featurebase_tpu/ops/bitwise.py:123"),
            ("bsi_sum_groups", "bsi_sum_groups/sharded_s128_g32_d14",
             ck.GROUP_SOURCE,
             "featurebase_tpu/ops/bsi.py:611, "
             "featurebase_tpu/ops/bsi.py:333"),
            ("var_moments", f"var_moments/s{S}_d14", ck.MOMENTS_SOURCE,
             "featurebase_tpu/ops/bsi.py:782"),
            ("corr_moments", f"corr_moments/s{S}_d14x12", ck.MOMENTS_SOURCE,
             "featurebase_tpu/ops/bsi.py:815"),
            ("bsi_decode", f"bsi_decode/s{S}_d14", ck.DECODE_SOURCE,
             "featurebase_tpu/ops/bsi.py:759, "
             "featurebase_tpu/ops/bsi.py:482"),
            ("bsi_decode_gather", "bsi_decode_gather/n1000_d14",
             ck.DECODE_SOURCE, "featurebase_tpu/ops/bsi.py:367"),
            ("percentile_counts", f"percentile_counts/s{S}_round_129",
             ck.DECODE_SOURCE, "featurebase_tpu/ops/bsi.py:491")):
        t = times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"featurebase_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t.get("bound_by", "bytes"), "library_ms": None})
    for name, replaces in (
            ("tune_ceiling", "tools/tune_count_kernel.py:85"),
            ("tune_csa_scalar", "tools/tune_count_kernel.py:121"),
            ("tune_direct_partial", "tools/tune_count_kernel.py:140"),
            ("tune_csa_partial", "tools/tune_count_kernel.py:140")):
        t = tune_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "featurebase_tpu_torch/csrc/tune_count.cu",
            "replaces": replaces, "launches": tune_launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    lap("processes")
    say("phase_seconds", **PHASE_SECONDS,
        total=time.perf_counter() - T0)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
