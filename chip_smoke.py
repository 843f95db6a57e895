#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, the CUDA toolkit (``nvcc``) and nothing of JAX.
Phases, each failing the run on any error or mismatch:

1. set-up: the card is present; the kernel libraries are built from
   ``spark_rapids_tpu_torch/csrc/groupby_kernels.cu``,
   ``csrc/join_kernels.cu``, ``csrc/udf_kernels.cu``,
   ``csrc/regex_kernels.cu`` and ``csrc/radix_kernels.cu`` (one ``nvcc``
   each for ``sm_90a``, started
   together with the ``g++`` build of the native host library from
   ``native/src``; ptxas' register and spill lines
   are printed); the card's name and power limit are read;
2. kernels: each hand-written kernel's wrapper runs on card tensors at the
   main path's shapes (2^24 rows; B = 128, 1024, 8192) and is held
   against its plain PyTorch version on the same inputs — integers and
   winners exactly, float sums within 1e-9 of each bucket's sum of |x|
   (the atomics' order effect); kernel, plain version and one library
   call (``index_add_`` / ``scatter_reduce_``) are timed with CUDA events
   over back-to-back calls (``ms``), beside the bytes bound at 3.35 TB/s;
   K2 and K5 also report the same calls queued behind a spin kernel, so
   that the host's time to issue them is not counted (``dev_ms``), and
   the wrapper's host time a call (``host_ms``). The ordered segment sum must
   equal numpy's serial ``bincount`` bit for bit, and has a second bound,
   its longest segment times the card's dependent f64 add latency, which
   a one-thread probe kernel from the same source measures in the run
   (a chain of 2^20 adds timed with CUDA events). The join probe kernel K4 runs at
   the bench join's shape (2^23 probe rows with 2-word keys, 5% dead,
   against a 2^17-row build with duplicate keys) and must equal, row for
   row, the ranges two ``torch.searchsorted`` calls give, and its plain
   version on a 2^16-row sample and in full at 2^20 x 2^13, on a build
   where one key holds most rows, and with a device build count whose
   garbage tail holds the probe keys; it also runs at Q8's shape (2^20
   probe rows against a 2^16-row build). The
   word-count kernel K5 runs on Q10's first batch as the query hands it
   over (2^20 rows, the pool padded to its capacity bucket) and must
   equal its plain version and the generator's own word counts on every
   row, also on a slice of the column whose offsets start mid-pool, with
   non-space garbage past its last offset. K2 also runs with every live
   row in one bucket and with five float columns, held to its plain
   version at the same tolerance;
3. queries, through the exec tree and ``collect()``, each checked against
   a numpy oracle on the host, with the kernel launch counters set to 0
   just before each query and read just after it (each query is one path;
   a path that does not launch its kernels fails the run):
     Q1 the bench query (filter a >= 0, project a2 = a*2, group by k:
        sum(a2), avg(b), count(b)) over 2^26 rows in 4 batches, AUTO +
        variableFloatAgg (-> the kernel tier);
     Q2 group by k: min(b), max(a), first(a), last(b);
     Q3 group by an int64 key of 40 values spread over the int64 range
        (the murmur3 hash tier and the representative-row kernel);
     Q4 2^20 distinct keys in 2^24 rows (three colliding hash tiers,
        then the sort fallback);
     Q5 group by k: exact sum(b) (no variableFloatAgg: the torch scatter
        tier with the order-preserving segment sum), run twice and
        required to be bit-identical;
     Q6 the bench join query (bench.py ``shape_join``: 2^23 fact rows
        join 100 000 dim rows on fk = dk, then group by fv: sum(dv),
        count(*)) under a forced PALLAS strategy: K4 once per probe
        batch, K1 in the aggregate;
     Q7 the same query under AUTO: the DIRECT tier, fused into the
        aggregate's update (no K4 launch);
     Q8 inner (with the residual dv > fv * 10000), left, right, full,
        semi and anti joins of 2^20 fact rows (2% null keys) and 2^16 dim
        rows (duplicate keys, 5% null), each under PALLAS and under AUTO,
        reduced on the card to row counts and per-column valid counts
        and sums;
     Q9 the bench string query (bench.py ``shape_string``, scale 1): 2^22
        rows of ``s`` from the bench's 56-entry pool in the bench's own
        layout (``bench.py:_dev_string_col``: the pool's 14 distinct
        values as a dictionary, int32 codes, ``unique`` set) and ``v``;
        filter contains(s, "X"), project upper(s)[1:6], length(s), v;
        grand aggregate; exact against the pool (per-entry values times
        entry counts); the string kernels run over the 14 entries. Q9x is
        the same query over the expanded Arrow layout. Each with a cold
        and three warm walls and a profiled run (device busy time);
     Q10 the native-UDF word count: 2^22 rows of generated text in 4
        batches, project (k, string_word_count(s)), group by k: sum, count
        of the count and count(*), exact against the generator's own word
        counts; K5 once per batch;
4. sort and window, exec trees at the bench's scale 1 against exact
   numpy oracles, each with its cold wall and three warm walls:
     Q13 bench.py ``shape_sort``: 2^23 rows (``rng(7)``: int64 ``key``
        in [-2^40, 2^40), int32 ``pay``), sort by key ASC NULLS FIRST,
        local limit 1000; the first 1000 rows of numpy's stable argsort;
     Q14 bench.py ``shape_window``: 2^23 rows (``rng(13)``: int32 ``k``
        64 groups, a permutation ``ts``, int64 ``v``), sum(v) and
        row_number() over (partition by k order by ts), filter rn <= 3;
        192 rows against a lexsort and per-group cumsum.
   Neither launches a hand kernel (torch sorts and scans); under
   ``--profile`` each also reports its sort kernels' device time.
5. session queries, from the session's own entry points
   (``TpuSession`` -> ``DataFrame`` -> ``collect()``: planner, type
   checks and fallback boundaries), with the counts set to 0 just before
   and read just after each:
     Q11 the bench's product query (bench.py ``shape_parquet``, scale 1):
        2^23 rows seeded as the bench does, written with pyarrow (row
        groups of 2^21 rows, pyarrow's defaults: dictionary pages,
        snappy) under ``_chip_data/``, then ``read.parquet`` -> where
        ss_sold_date_sk >= 2452015 -> group by ss_quantity: sum of
        ss_wholesale_cost and count of ss_item_sk under
        variableFloatAgg; the pages decode on the card. Run cold (fresh
        process-level scan and scanner caches; the file was just written,
        so it is still in the OS page cache: process-cold, not disk-cold)
        and then three times warm (the device scan cache), each against a
        numpy oracle (counts exact, sums within 1e-9 of each group's sum
        of |x|); the plan must be aggregate <- filter <- file scan with no
        CPU exec, the cold run must decode every column chunk on the
        device route (no chunk through pyarrow's host decode, no split
        through the plain reader, fewer bytes uploaded than decoded), and
        the query must launch K1 and K2. pyarrow is installed on the card's machine (24.0.0 when
        checked), so Q11 reads parquet there; the script does not
        branch on it;
     Q15 a TPC-DS-shaped top-N over Q11's file in the same session:
        where ss_sold_date_sk >= 2452015 -> group by ss_item_sk:
        count(ss_quantity) n, sum(ss_wholesale_cost) s -> order by n
        DESC, ss_item_sk -> limit 100; keys and counts exact, sums
        within 1e-9 of each group's sum of |x|; the plan must be collect
        limit <- sort <- aggregate <- filter <- file scan, on the device;
        the first run's launches are recorded and the three warm runs
        must repeat them;
     Q12 the fallback boundary: 2^16 rows from ``create_dataframe``,
        project k and a Python UDF (``-> int``), then group by k: sum and
        count of its result under the default conf. ``explain()`` must
        give the reference's lines (``Q12_EXPLAIN``: the project falls
        back because PythonUDF is not supported), the executed plan must
        hold the CPU project between a RowToColumnarExec under the device
        aggregate and the device scan's ColumnarToRowExec, and K1 must
        launch; exact against a numpy oracle;
     Q16 Q12 with ``spark.rapids.tpu.sql.udfCompiler.enabled``, over
        Q12's UDF and a branching one (``v * 3 + 1 if v > 100 else
        -v``): both compile to device expressions, ``explain()`` shows
        no fallback, the device tree holds no row/columnar boundary, and
        the rows equal Q12's and the Python functions' row by row, in a
        cold and three warm runs that must launch the same kernels; K1
        must launch;
     small: range -> union -> local limit -> posexplode -> collect limit
        through the session, every operator on the device, the rows held
        to the same query on the port's CPU engine.
6. string keys, 2^23 rows each, every query against a numpy oracle
   (strings in numpy's bytewise ``S`` order), with its cold wall, three
   warm walls, input bytes and bound, and the launches of each of the
   four runs set to 0 before it and required to repeat the first's:
     Q17 TPC-H Q1 (pricing summary report) through the session from
        parquet: ``lineitem`` after the spec's rules, decimals as f64 and
        dates as int32 days, written by pyarrow in 4 row groups with the
        string columns PLAIN; where l_shipdate <= 1998-09-02 -> group by
        l_returnflag, l_linestatus: the four sums, three averages,
        count(*), min and max of l_shipmode -> order by both keys;
        ``dictStrings`` off and variableFloatAgg on (the planner keeps a
        float sum on the CPU without it), under SCATTER (Q17) and AUTO
        (Q17v, PALLAS on the card) and RADIX (Q17r). String keys take
        the sort path: under SCATTER the ordered segment sum runs 7 times
        per scan batch and once more per sum in the merge; under PALLAS
        and RADIX the RADIX kernel runs once per scan batch and once in
        the merge; no hash-tier kernel; the plan must be sort <-
        aggregate <- filter <- file scan, on the device. Then one more
        Q17 run records the ordered sum's first call over a whole scan
        batch (its four skewed segments), which is held to numpy's serial
        ``bincount`` and its plain version and timed beside
        ``index_add_``, its bytes bound and its chain bound; one more
        Q17v run records the RADIX kernel's first call over a scan batch
        (2^21 rows, four groups, TPC-H Q1's aggregates), held to its
        plain version (counts, sums, positions and winner rows exactly,
        float sums within 1e-12 of Σ|x|), also on its first 2^17 rows at
        a forced 1000-row reference tile with max and min winners over
        the float columns (ties across tiles), and timed beside its
        bytes bound and one ``torch.segment_reduce``;
     Q18 a string-keyed equi-join with string payloads (TPC-DS q8/q24's
        join on a 5-digit zip): 2^23 fact rows in 4 probe batches (5%
        null zips, 2% absent from the dim) join 100 000 dim rows (unique
        zips, a city from 600 names of 4-20 bytes, a 2-byte state), then
        group by city: count, sum(net_paid), min(state), max(state);
        under PALLAS (Q18: K4 once per probe batch on the zips' two chunk
        words) and AUTO (Q18a); the ordered sum once per partial and in
        the merge. One more Q18 run records the ordered sum's first call
        over a probe batch's join output, held and timed as in Q17. Then
        K4 on one probe batch's words against the dim's, held to its
        plain version and to two ``searchsorted`` calls, and
        Q18s: every join type (and an inner join with a residual) over
        10-byte keys (4 words: SEARCH under PALLAS, no K4), 2^20 x 2^16
        rows with duplicate and null keys, each under PALLAS and AUTO,
        reduced on the card (string columns to their byte sums);
     Q19 an item table (i_item_id "AAAAAAAA" + 8 letters A-P, TPC-DS's
        ten categories, brand ids 1-1000, sales): (a) order by i_item_id
        desc, local limit 100; (b) rank() over (partition by i_category
        order by sales desc), filter rank <= 3; (c) group by i_brand_id:
        min and max of i_item_id, count(*) under AUTO (PALLAS on the
        card): the hash tiers reduce the ids' rank columns on K3,
        exactly ``Q19C_LAUNCHES``. Then one more (c) run records K1's
        call on the 1024-bucket direct tier, held to its plain version
        and timed beside ``index_add_``, and K3 runs on the ids' rank
        column over that tier, held to its plain version and timed beside
        ``scatter_reduce_``.
7. dictionary-encoded strings, 2^23 rows each, against exact oracles,
   with cold and warm walls as in 6 (``--profile`` adds a profiled run
   of each):
     Q20 TPC-H Q1 as files hold it: Q17's rows written by pyarrow with its
        default dictionary encoding on every column, read through a port
        ``TpuSession`` with default confs (``dictStrings`` on: the string
        columns scan as the files' dictionaries and int32 codes) and
        variableFloatAgg, under SCATTER (Q20: no hash-tier kernel) and
        AUTO (Q20v: K1, K2 and K3). The unique dictionary keys group on
        their codes on the direct tier (``describe()`` must say so); the
        merge of the four partials materializes the keys and takes the
        string sort path (the ordered sum, 7 calls). One more Q20v run
        records K1's and K2's first calls over a scan batch, held to their
        plain versions and timed beside ``index_add_``;
     Q21 Q19's item table with i_category and i_brand (1000 dsdgen-like
        names, one per i_brand_id) dictionary-encoded: (a) group by
        i_category: min and max of i_brand, count(*), sum(sales) under
        AUTO: the codes on the direct tier (K1) and i_brand's min and max
        over the ranks of a sort of its 1000-entry dictionary (K3); (b)
        order by i_category, i_brand, local limit 100 (the sort
        materializes; no kernel). One more (a) run records K3's first
        call over the batch, held to its plain version and timed beside
        ``scatter_reduce_``.

8. the other string expressions (item 15), over TPC-H's ``orders`` (2^23
   rows: o_comment a dbgen-like 19-78-byte slice of a seeded text pool
   of the spec's grammar) and ``customer`` (838 861 rows), written by
   pyarrow with its defaults under ``_chip_data/`` (four row groups of
   orders; removed after):
     the DFA row matcher: over o_comment's 2^23 rows as one column, each
        pattern's kernel (Q22d's, an anchored one, a '$' over rows that
        end in '\n' and a class that takes multi-byte UTF-8, the last
        three on a copy with '\n' endings, 'é's and nulls) held to its
        plain version bit for bit over the whole column, its first 2^20
        rows and a 2^16-row slice whose offsets start mid-pool, and
        timed beside its whole-row bytes bound, the bytes its walk must
        read up to its stop (``dfa_exit_plain``) and the 32-byte sectors
        holding them; then over 12 288 rows of 1-64 KB;
        ``special.*requests`` must be
        refused by the compiler (more than 16 DFA states), as the
        reference's refuses it;
     Q22 TPC-H Q13 through the session: customer left outer join the
        orders whose comment is not like '%special%requests%' (join
        strategy PALLAS: K4), count(o_orderkey) per customer (838 861
        groups), count(*) per c_count (K1), by custdist desc, c_count
        desc; Q22r the same with ``not rlike 'special.*requests'``,
        which no device route takes: the planner runs that filter on the
        CPU engine, over the orders' first row group only (2^21 of the
        2^23 orders, one cold run) and the rows must be the LIKE's over
        those orders; Q22d with
        ``not rlike '^[a-z]+ (sly|furious)'``, which runs on the DFA
        kernel; each against a numpy oracle from the text pool's word
        positions (itself held to Python's ``re`` on a sample);
     Q23 TPC-H Q22: the scalar subquery's average first, then the
        customers of seven country codes (``substring(c_phone, 1, 2)
        in (...)``) above it with no orders (an anti join), count and
        sum(c_acctbal) by code, against numpy;
     Q24 the item-15 functions as one projection over Q19's item table
        (initcap, locate, replace, regexp_replace, lpad, rpad,
        substring_index, split_part, like with '_', string In, the casts
        to bigint and double, coalesce and case when), each on a plain
        and on a dictionary-encoded column, held to Python's string
        functions on a seeded 2^16-row sample; Q24c cast(c_custkey as
        string), its cast back (which must give c_custkey) and
        cast(substring(c_phone, 1, 2) as int) over every customer.

9. the exchanges (items 10 and 9): earlier tables written as several
   parquet files (one row group each) under ``_chip_data/`` (removed
   after), so that the session's plans run over several partitions;
   each query with a cold and three warm walls (launches set to 0 before
   each run, every run repeating the first's, device memory after each
   warm run equal within 16 MiB: the exchanges release their pieces), a
   profiled run (busy time, idle share), its exchanges' metrics
   (``partitionSize``, ``dataSize``, ``shuffleBytesWritten``) and its
   plan from ``explain_metrics()``, which must name the exchange:
     Q11m Q11's table as 8 files: partial -> hash exchange -> AQE
        coalescing read -> final, K1 and K2 in both halves (more
        launches than files); Q11mo the same with both fused aggregate
        routes off; Q11mh the same under
        ``shuffle.transport.class=host`` (the wire format on the path);
     Q20m TPC-H Q1 over Q20's lineitem as 4 dictionary-encoded files
        under AUTO (K1, K2 in the partials) and Q20ms under SCATTER (the
        ordered sum only); the dictionaries materialize at the map side
        and the ORDER BY runs through a range exchange with string
        bounds; ``q17_oracle``;
     Q22m TPC-H Q13 over Q22's orders (4 files) and customer (2 files):
        the left join through two hash exchanges and the AQE join pair
        (K4 under PALLAS), both aggregates and the sort through
        exchanges; Q22's oracle;
     Q18m Q18's zip join: the 2^23 fact rows as 4 files, the 100 000-row
        dimension as one file below the 10 MB broadcast threshold, so
        the broadcast exchange and hash join (K4 once per probe batch,
        4), the group by city through a hash exchange; ``q18_oracle``;
     Q14m Q14's window over 4 files: the window gathers the partitions;
     Q11mz Q11mh under ``shuffle.compression.codec=lz4`` (the native
        block codec on the wire format: its bytes and encode/decode times);
     Q28 (item 25) TPC-H Q1 over Q20m's 4 files, sampled as Spark's
        ``sample``: a projection appends ``rand(42)`` and a filter keeps
        ``rand < 0.25`` (the filter and the aggregate run on the card; K1
        and K2 must launch), against a numpy oracle whose rand is the
        reference's splitmix64 stream over (seed, partition, row) in
        ``np.uint64``, bit for bit; Q28i a second projection of
        ``monotonically_increasing_id()``, ``spark_partition_id()``,
        ``input_file_name()`` and ``hash(l_returnflag, l_linestatus,
        l_quantity)`` grouped by file: count, min/max id and partition
        id, and the int64 sum of the hash, exact against numpy (a numpy
        murmur3), and the hashes of a 4096-row sample against the port's
        scalar murmur3.

   Item 27 (the native host decoders): Q11's, Q17's, Q20's and Q22's
   cold runs report their scans' ``hostDecodeTime`` and the hybrid
   streams decoded by route (``parquet_device.DECODE_ROUTES``); the run
   fails if any query's stream took the numpy route. Each of those files
   is also planned on the host alone (every column chunk decompressed and
   decoded, no device): the C++ decoder on 1 to 8 threads and the numpy
   decoder (the library hidden, as on a host without a compiler) on one,
   every pass of each planning the same number of chunks (a chunk the
   device route refuses goes to the host reader and is not counted);
   and Q11 runs cold with a host-decode pool of 1, 2, 4 and 8 threads
   (the measurement behind ``parquet_device.DECODE_THREADS``).

11. the memory plane (items 4 and 11), each run against its own
   un-faulted run's rows, with its wall and its peak device memory
   (``torch.cuda.max_memory_allocated`` above what was allocated before):
     Q29a Q20v's TPC-H Q1 (AUTO: K1, K2, K3) with
        ``test.faults.oom`` firing while the aggregate update's batch
        capacity exceeds 2^20 rows: each 2^21-row batch fails twice and
        splits once (the harness's attempts and split depth reported);
        keys, counts and min/max exact, sums within 1e-12 of sum|x|
        (the split changes the order of the float sums under
        ``variableFloatAgg``, so their last bits may differ);
     Q29b the bench join Q6's join under a real
        ``torch.cuda.OutOfMemoryError``, its output reduced on the card
        batch by batch (``_reduce_join``): its unsplit peak measured, then
        the process capped (``set_per_process_memory_fraction``) at what
        was reserved plus a factor of that peak, found on the card, so
        that the probe's first attempt cannot fit; the probe must split
        (depth >= 1), K4 launch on the halves and the reduction equal the
        unsplit run's; the cap is lifted after;
     Q29c Q6 with ``memory.hbm.budgetBytes`` at 1 MiB: the sorted build
        spills to the host as it registers and comes back for the probe,
        which holds it pinned: two spills and two unspills exactly
        (spilled bytes reported), K4 once and Q6's rows; run with both
        fused routes off, twice under AUTO, and off again.

10. decimals, dates and timestamps (item 6), over TPC-DS ``store_sales``
   with its spec types: 2^23 rows (SF ~2.9) seeded from dsdgen's pricing
   (wholesale 1.00-100.00, markup, discount, quantity 1-100;
   ``ss_ext_sales_price`` and ``ss_net_profit`` decimal(7,2)), sold-date
   keys uniform over the sales window 2450816-2452642 with 4% NULL,
   12 stores, plus ``ss_sold_date`` (DATE, the key's d_date) and
   ``ss_sold_ts`` (TIMESTAMP, that date plus a seeded time of day),
   written as 4 files of one row group with ``store_decimal_as_integer``
   (INT32 decimals, Spark's layout); all 73 049 ``date_dim`` rows and
   the 12 ``store`` rows with pyarrow's defaults. Each query with a cold
   and three warm walls, a profiled run, launches set to 0 before each
   run, and ``explain()`` with no CPU node:
     Q25 TPC-DS q5's store channel (sales and profit by s_store_id over
        the 15 days from cast('2000-08-23' as date) to its date_add of
        14) under join PALLAS (K4 twice per store_sales partition) and
        Q25a under AUTO; s_store_id leaves the broadcast join expanded,
        so the decimal sums run on the string sort path (no K1);
        decimal(17,2) results exact against numpy;
     Q26 every item-6 function in one projection over the 2^23 rows: the
        date and time fields, date_add/date_sub/datediff/last_day,
        trunc by year and month, unix_timestamp/from_unixtime, timestamp
        + interval, the date <-> timestamp and date/timestamp -> string
        -> back casts, decimal + - * / across scales, decimal casts to
        and from int, bigint, double and decimal, compares with decimal
        literals, IN, unary minus and abs; every output held on the card
        to its numpy / ``datetime`` oracle (dates computed over the
        distinct days and gathered), the strings by their lengths, byte
        sums or round trips and a 2^12-row sample against Python's
        formatting; no kernel launches;
     Q27 group by ss_sold_date: count(*), sum(ss_ext_sales_price),
        avg(ss_net_profit) (decimal(11,6), HALF_UP), min(ss_net_profit),
        max(ss_sold_ts), order by the date: 1 827 date keys on the direct
        tier, K1 on the sums and K3 on the min and max, exact against
        numpy and Python's ``Decimal``.
12. nested-loop and cartesian joins (item 8), through the session over
   parquet files, each against a numpy oracle with its walls, launches,
   exchanges and a profiled run:
     Q30 TPC-DS q88: Q25's 2^23 store_sales rows (4 files) with
        ss_sold_time_sk and ss_hdemo_sk, time_dim (86 400 seconds),
        household_demographics (7 200 rows) and store (12, two named
        'ese'); eight count(*) subqueries, one per half-hour slot from
        8:30 to 12:30, each store_sales joined to the three filtered
        dimensions, cross-joined into one row: seven
        ``TpuCartesianProductExec``s over broadcast exchanges;
     Q31 a band join: 2^23 incomes uniform in [0, 200 000] (4 files: 4
        probe batches of 2^21 rows) against TPC-DS's income_band (20
        rows), ``v between ib_lower_bound and ib_upper_bound`` (4.2e7
        pairs a batch in ``TpuBroadcastNestedLoopJoinExec``), group by
        ib_income_band_sk: count, sum(v) (K1).
13. observability (items 7 and 13, and item 26's observability part):
   three queries through the session at full width, each a cold and
   three warm walls with every observability key at its default, then
   again with the event log (a temporary ``eventLog.dir``),
   ``metrics.deviceSync.enabled``, live metrics, the HTTP exporter and
   the watchdog on:
     Q20v-obs Q20v's TPC-H Q1 (one pyarrow-default file, AUTO);
     Q22m-obs Q22m's TPC-H Q13 (two hash exchanges, the AQE join pair,
        K4; join PALLAS);
     Q29c-obs Q6's join through the session over parquet (2^23 fact rows
        in one row group, the 100 000-row dim broadcast), group by fv,
        order by fv, join PALLAS, ``memory.hbm.budgetBytes`` at 1 MiB:
        the broadcast batch and the sorted build spill and come back.
   Each kernel's launches (and the aggregates' routes) must equal the
   run's with logging off, and no plain version may run. Every JSONL
   record has its type's required fields; ``query_start.env`` says
   ``backend`` gpu and names the card; the ``agg_strategy`` and
   ``join_strategy`` picks are the strategies the plan's ``describe()``
   shows; every exec that recorded a batch has ``op_span``s on both
   lanes; the root's ``op_batch`` rows sum to each query's collected
   rows; each query's device-lane time stays under its ``query_end``
   duration; Q22m's ``shuffle_fetch`` rows equal its ``shuffle_write``
   rows per reduce partition; Q29c's ``spill`` events equal the
   catalog's spill and unspill counts and bytes over the logged runs;
   at every ``heap_snapshot`` the ledger's ``buffer_alloc``/``free``
   (and bid-stamped spills) add up to its ``live_bytes``, with no leak.
   A scrape of ``/metrics`` on 127.0.0.1 shows ``tpu_agg_strategy`` and
   ``tpu_join_strategy``, ``/status`` parses as JSON, and
   ``export_trace`` writes a Chrome trace whose ``traceEvents`` load.
   One line a query gives the walls off and on beside the card's name
   and power limit.
14. the mesh (item 28): bench.py's six mesh shapes at scale 1
   (``bench.py:731-925``, rebuilt here from the same seeds) under
   ``shuffle.mode=ici`` over a mesh of 4 virtual devices on the one card
   (``SRTPU_TORCH_VIRTUAL_DEVICES=4``, ``mesh.devices=4``,
   ``variableFloatAgg`` as the bench's mesh lane sets it), each a cold
   and two warm walls with the launch counts zeroed before each run and
   read after it, no plain kernel version called, its mesh stages and
   shards printed, and held to the port's host-exchange plan of the same
   query on the card (integers bit for bit, rows as multisets, the
   sort's keys in order; float averages and sums within 1e-9 of each
   group's Σ|x|): M-agg (2^26 rows: the sharded scan, filter and project
   absorbed per shard, sum, avg, count; K1 and K2 must launch) and
   M-aggm (min, max: K3), M-sort, M-join (2^23 x 100 000), M-window
   (2^23), M-string (2^22, string keys: the RADIX kernel), M-parquet (2^23
   rows through the session, row groups round-robined onto the shards;
   K1 and K2), and M-net, M-parquet's query under the single-process
   exchange with ``shuffle.transport.class=network`` against the
   ``host`` transport (:func:`mesh_phase`).
15. serving (item 26's serving part, :func:`serve_phase`): Q11, Q20v,
   Q18m and Q25 at their full sizes, their files written again from
   their phases' seeds. S-solo: each alone through a session with
   ``serve.enabled`` and the event ring on, against its phase's oracle,
   with its launches, the plan analyzer's ``peak_hbm`` beside the peak
   the caching allocator measured around the run
   (``max_memory_allocated`` less the baseline) and the HBM ledger's
   observed peak (a forecast below the measured peak is printed, not
   failed). S-mix: four sessions on four threads, one query each (Q18m's
   with ``serve.priority=1``), each submitting it 3 times, under a
   ``memory.hbm.budgetBytes`` of the largest forecast plus half the
   second (the two largest cannot be admitted together); every result
   against its oracle, each kernel's launches exactly 3x the sum of its
   S-solo launches (K1-K4 > 0), at least one ``queue`` verdict in
   ``QueryScheduler.stats()`` and the admission records, no reservation
   left, ``/status`` read from the exporter while a ticket waits (its
   ``serve`` block shows it), the threads joined with a timeout (a wedge
   fails the run); the budget, every ticket's forecast and its source,
   the makespan beside 3x the solo walls. S-reject: Q11 under a budget
   of half its forecast must raise ``ServeAdmissionRejected`` and leave
   no ticket or reservation.
16. files (item 26's formats and export parts, :func:`io_phase`): Q17's
   ``lineitem`` at 2^23 rows (TPC-H SF 1.4; strings, f64 money, int32
   days) written by pyarrow as 4 CSV files and as 4 ORC files (pyarrow's
   default stripes) under ``_chip_data/io``. W-csv: TPC-H Q1 over
   ``read.csv`` with the schema given, W-csvi with it inferred from the
   first file (rows equal to W-csv's), W-orc over ``read.orc`` with the
   ``l_shipdate`` filter pushed into the host read (rows uploaded equal
   the kept rows); each under AUTO, a cold wall and three warm ones
   (W-csvi and W-orc one), the host read's share, no CPU exec in the
   plan, the RADIX kernel launched.
   W-write: W-csv's files filtered at Q1's cutoff and projected (flag,
   status, mode, qty, disc_price) written by ``df.write.parquet``,
   ``.orc`` and ``.csv`` (each stats dictionary counts the oracle's rows,
   no ``._temporary`` file left), each read back through the session and
   aggregated by (flag, status): sum(qty), sum(disc_price), count,
   min/max(mode), a cold and a warm wall (the parquet read-back on the
   dictionary-code route: K1, K2 and K3; ORC and CSV: the RADIX kernel);
   then the parquet file, now
   cached on the device, overwritten with a narrower filter: the commit
   empties the device scan cache of it and the next read gives the new
   rows. W-ml: ``exportColumnarRdd`` on, ``columnar_rdd`` over the
   filtered numeric columns (every tensor on the card, DLPack sharing
   each column's storage, the oracle's row count), ``to_numpy_batches``
   equal to the oracle's arrays, and ``map_in_arrow`` (a
   ``pyarrow.compute`` function a batch) and ``map_in_pandas`` (the same
   in pandas) over the first 2^20 rows, each followed by a group-by on the
   card (K1 and K2). Counts exact, float sums within 1e-9 of Σ|x|.

Q1r, Q1m and Q1s are Q1 under a forced RADIX (the RADIX kernel once
per batch and in the merge), MATMUL (the f32 one-hot limb products, no
hand kernel; the average within the hi/lo split's rtol 1e-4) and SORT
(prefix differences, the float sum on the ordered sum), each against
Q1's oracle. Q4's sort fallback (and Q15's, Q20v's merge) reduce on the
RADIX kernel; Q4's call is recorded and held to the plain version and
timed as Q17v's is, with its own ``kernels`` entry.

The fused aggregate routes (items 3 and 5): Q1p is Q1's query over Q1's
first 2^24 rows in 8 batches (the fused plan's row guard) under AUTO
(the fused plan), under ``sql.agg.fusedPlan=OFF`` and under AUTO with an
``oom`` fault at the plan site (the fallback to the streaming path),
each a cold and three warm walls with its peak device memory, K1 and K2
9 times each on every route. Q11's AUTO run must take the fused stage;
Q11o repeats it with ``sql.stageFusion=OFF`` (the fused plan over the
scan's batches) and Q11u with both off (the streaming route), Q11mo is
Q11m with both off, each with Q11's launches. Q29b adds Q6 whole under
AUTO and with both off, Q29c a run with both off before and after its
AUTO runs, each with its peak memory. Every query line whose path ran an aggregate carries
``agg_route``: its aggregate partitions by route (``stage``, ``plan``,
``update``; :data:`AGG_ROUTES`, from the aggregates' ``op_timed``
sections).

The kernel phase also runs K1 and K3 at Q4's shape (B = 8192 buckets
filled evenly, K1 with Q4's five columns: a 192 KB shared-memory table);
K1 and K3 at that shape, K4 at Q8's and Q18's, the ordered sum at
Q17's and Q18's, K1 and K3 at Q19(c)'s, K1 and K2 at Q20v's and K3 at
Q21(a)'s have their own entries in the ``kernels`` line; the DFA row
matcher's entry is its time at Q22's shape with Q22d's pattern.

Cuts of depth, to keep the whole script in its time as phases are
added: Q22r reads the orders' first row group only (since the mesh
phase came; its CPU-engine filter over all 2^23 orders took 143 s on
the H100's host, the longest step of the script); W-ml's
``map_in_arrow`` and ``map_in_pandas`` run over the first 2^20 rows
(their results come back as Python lists, as the reference's data plane
has them).

Output: one JSON line per kernel shape and per query, then one
``{"kernels": [...]}`` line (each kernel's ``launches`` are those of its
own path, named in ``path``; ``launches_by_path`` gives every query's), then the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
#: dim rows of the bench join (bench.py shape_join): Q6, Q7 and K4's build
DIM_ROWS = 100_000
GROUPBY_SOURCE = "spark_rapids_tpu_torch/csrc/groupby_kernels.cu"
JOIN_SOURCE = "spark_rapids_tpu_torch/csrc/join_kernels.cu"
UDF_SOURCE = "spark_rapids_tpu_torch/csrc/udf_kernels.cu"
REGEX_SOURCE = "spark_rapids_tpu_torch/csrc/regex_kernels.cu"
RADIX_SOURCE = "spark_rapids_tpu_torch/csrc/radix_kernels.cu"
SOURCES = {"bucket_sum": GROUPBY_SOURCE, "bucket_float_sum": GROUPBY_SOURCE,
           "bucket_winner": GROUPBY_SOURCE,
           "ordered_segment_sum": GROUPBY_SOURCE,
           "probe_ranges": JOIN_SOURCE, "word_counts": UDF_SOURCE,
           "dfa_accept_rows": REGEX_SOURCE,
           "radix_segment_reduce": RADIX_SOURCE}
#: the query whose run each kernel's ``launches`` and timed shape stand for
#: (the RADIX kernel's timed shape is one Q17v partial's call, keyed so)
PATH = {"bucket_sum": "Q1", "bucket_float_sum": "Q1",
        "bucket_winner": "Q2", "ordered_segment_sum": "Q5",
        "probe_ranges": "Q6", "word_counts": "Q10",
        "dfa_accept_rows": "Q22d", "radix_segment_reduce": "Q17v"}
REPLACES = {
    "bucket_sum": "spark_rapids_tpu/ops/pallas_groupby.py:76",
    "bucket_float_sum": "spark_rapids_tpu/ops/pallas_groupby.py:115",
    "bucket_winner": "spark_rapids_tpu/ops/pallas_groupby.py:240",
    # not a Pallas kernel: the XLA segment_sum of the exact float sums
    "ordered_segment_sum": "spark_rapids_tpu/ops/groupby.py:910",
    "probe_ranges": "spark_rapids_tpu/ops/pallas_join.py:36",
    "word_counts": "spark_rapids_tpu/udf/native.py:52",
    # not a Pallas kernel: the XLA associative scan of the regex DFA
    "dfa_accept_rows": "spark_rapids_tpu/ops/regex.py:563",
    # not a Pallas kernel: the XLA fori_loop of the RADIX tiles
    "radix_segment_reduce": "spark_rapids_tpu/ops/radix_bin.py:221",
}
#: Q10's text comes in this many batches
WORD_COUNT_BATCHES = 4
#: the CUDA symbols of the kernels, for the profiles' per-kernel time
KERNEL_SYMBOLS = ("bucket_sum_kernel", "bucket_fsum_kernel",
                  "bucket_winner_kernel", "ordered_segment_sum_kernel",
                  "probe_ranges_kernel", "word_counts_kernel",
                  "dfa_accept_rows_kernel", "radix_staged_tiles_kernel",
                  "radix_span_fold_kernel")


def _kernel_modules():
    from spark_rapids_tpu_torch.ops import (groupby_kernels, join_kernels,
                                            radix_kernels, regex_kernels,
                                            udf_kernels)

    return (groupby_kernels, join_kernels, udf_kernels, regex_kernels,
            radix_kernels)


class Launches(dict):
    """Every kernel wrapper's launch count, read just after a path ran,
    with the routes its aggregates took (``agg_route``: partitions by
    route, :data:`AGG_ROUTES`; empty when no aggregate ran)."""

    agg_route: dict = {}


#: aggregate partitions by route since the last :func:`reset_launches`,
#: counted as the aggregates enter their ``op_timed`` sections (the
#: sections ``TpuExec.sections`` counts per exec): ``stage`` and ``plan``
#: once for each partition on a fused route, ``update`` once for each
#: partition that ends in the streaming merge (its ``merge`` section; a
#: fused plan that fell back counts ``plan`` and ``update``)
AGG_ROUTES = {"stage": 0, "plan": 0, "update": 0}
ROUTE_OF_SECTION = {"stage": "stage", "plan": "plan", "merge": "update"}
_ROUTES_LOCK = threading.Lock()


def count_agg_routes() -> None:
    """Count :data:`AGG_ROUTES` in this process: each aggregate's
    ``op_timed`` also adds its section's route (once; the partitions of
    a query may run on other threads)."""
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec

    if "op_timed" in vars(TpuHashAggregateExec):
        return
    timed = TpuHashAggregateExec.op_timed

    def op_timed(self, section: str = "", *args, **kwargs):
        route = ROUTE_OF_SECTION.get(section)
        if route:
            with _ROUTES_LOCK:
                AGG_ROUTES[route] += 1
        return timed(self, section, *args, **kwargs)

    TpuHashAggregateExec.op_timed = op_timed


def reset_launches() -> None:
    count_agg_routes()
    for mod in _kernel_modules():
        mod.reset_launches()
    with _ROUTES_LOCK:
        for k in AGG_ROUTES:
            AGG_ROUTES[k] = 0


def launches() -> dict:
    """Every kernel wrapper's launch count (a :class:`Launches`)."""
    out = Launches()
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    with _ROUTES_LOCK:
        out.agg_route = {k: v for k, v in AGG_ROUTES.items() if v}
    return out


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: cycles of the spin kernel that :func:`dev_ms`'s calls queue behind
#: (about 6 ms)
SPIN_CYCLES = 10_000_000


def dev_ms(torch, fn, reps: int) -> float:
    """:func:`cuda_ms` with the calls queued behind a spin kernel
    (``torch.cuda._sleep``), so the card runs them back to back and the
    host's time to issue them (Python, the wrapper, the launch) is not
    counted unless it exceeds the spin: the device's time a call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds to issue one call (host clock, the card left
    to finish afterwards): a wrapper whose host time exceeds its device
    time sets the pace of back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def emit(obj) -> None:
    """Print ``obj`` as one JSON line. A query line whose ``launches``
    were read by :func:`launches` gets its ``agg_route`` when an
    aggregate ran on that path."""
    c = obj.get("launches") if isinstance(obj, dict) else None
    if (isinstance(c, Launches) and "query" in obj and c.agg_route
            and "agg_route" not in obj):
        obj = {**obj, "agg_route": c.agg_route}
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def kernel_phase(torch, np, dev, n: int, reps: int):
    from spark_rapids_tpu_torch.ops import groupby_kernels as K
    from spark_rapids_tpu_torch.ops.sort import SIGN64

    rng = np.random.default_rng(7)
    results = {}

    def upload(a):
        return torch.from_numpy(a).to(dev)

    def seg_for(B):
        # the main path's seg: live rows in [0, min(B, 64)), filtered and
        # padding rows at B, plus a few negative ids
        s = rng.integers(0, min(B, 64), n).astype(np.int32)
        s[rng.random(n) < 0.5] = B
        s[rng.random(n) < 0.001] = -1
        return upload(s)

    def in_range(seg, B):
        return (seg >= 0) & (seg < B)

    def k1(seg, B, int_cols, cnt_cols):
        return sum_shape(torch, dev, seg, B, int_cols, cnt_cols, reps)

    def k3(seg, B, op, word):
        return winner_shape(torch, dev, seg, B, op, word, reps)

    def k2(seg, B, fcols):
        return fsum_shape(torch, dev, seg, B, fcols, reps)

    # the card's dependent f64 add latency: one thread, a chain of 2^20
    # adds in registers (0 + 1 - 0.5 + 1 - 0.5 ... = 2^18 exactly)
    nadds = 1 << 20
    x = torch.tensor([0.0, 1.0, -0.5], dtype=torch.float64, device=dev)
    if float(K.dadd_chain(x, nadds)) != nadds / 4:
        raise AssertionError("dadd_chain: wrong sum")
    chain_ms = cuda_ms(torch, lambda: K.dadd_chain(x, nadds), 5)
    dadd_ns = chain_ms * 1e6 / nadds
    emit({"probe": "dadd_chain", "adds": nadds, "ms": chain_ms,
          "dadd_ns": dadd_ns})

    for B in (128, 1024, 8192):
        seg = seg_for(B)
        live = in_range(seg, B)
        # K1 at the bench query's column mix: sum(a2) + 4 counts
        a2 = upload(rng.integers(-2 * 10**6, 2 * 10**6, n).astype(np.int64))
        va = upload(np.ones(n, bool))
        vb = upload(rng.random(n) >= 0.05)
        results[("bucket_sum", B)] = k1(seg, B, [(a2, va)],
                                        [live, va, vb, vb])

        # K2 at avg(b): one f64 column with nulls, plus NaN/inf rows
        bv = rng.normal(size=n) * 1e3
        bv[rng.random(n) < 1e-6] = np.nan
        b = upload(bv)
        results[("bucket_float_sum", B)] = k2(seg, B, [(b, vb)])

        # K3 at min(b): the order words of a nullable f64 column
        word = K._order_words(b, ~vb, "min")
        results[("bucket_winner", B)] = k3(seg, B, "min", word)

        # ordered segment sum at Q5's shape: rows sorted by bucket; the
        # serial row-order sum must equal numpy's (serial) bincount
        # bit for bit
        sseg, order = torch.sort(seg, stable=True)
        sv = torch.where(vb, b, 0.0)[order]
        results[("ordered_segment_sum", B)] = ordered_sum_shape(
            torch, np, dev, sv, sseg, B, reps, dadd_ns)
        for name in ("bucket_sum", "bucket_float_sum", "bucket_winner",
                     "ordered_segment_sum"):
            emit({"kernel_shape": name, "rows": n, "B": B,
                  **results[(name, B)]})
        del seg, live, a2, va, vb, b, word, sseg, sv, order
        torch.cuda.empty_cache()

    # K2 at its worst contention (every live row in one bucket of Q1's
    # B = 128) and with five float columns, held to the plain version
    B = 128
    seg = seg_for(B)
    one = torch.where(in_range(seg, B), 63, seg)
    fcols = [(upload(rng.normal(size=n) * 10.0 ** i),
              upload(rng.random(n) >= 0.05 * i)) for i in range(5)]
    for what, s_, cols in (("one_bucket", one, fcols[:1]),
                           ("five_columns", seg, fcols)):
        r = k2(s_, B, cols)
        emit({"kernel_shape": "bucket_float_sum", "rows": n, "B": B,
              "check": what, "columns": len(cols), **r})
    del seg, one, fcols
    torch.cuda.empty_cache()

    # K1 and K3 at Q4's shape: 2^20 keys hashed into the B = 8192 tier,
    # every row live, so the buckets fill evenly. K1 carries Q4's five
    # columns (sum(a), its count, count(b), max(b)'s count and the row
    # count): 8192 x (8 + 4 x 4) bytes, one 192 KB shared table. K3 is
    # max(b)'s winner.
    B = 8192
    seg = upload(rng.integers(0, B, n).astype(np.int32))
    a = upload(rng.integers(-(10**6), 10**6, n).astype(np.int64))
    va = upload(np.ones(n, bool))
    vb = upload(rng.random(n) >= 0.05)
    results[("bucket_sum", "Q4")] = k1(seg, B, [(a, va)], [va, va, vb, vb])
    word = K._order_words(upload(rng.normal(size=n)), ~vb, "max")
    results[("bucket_winner", "Q4")] = k3(seg, B, "max", word)
    for name in ("bucket_sum", "bucket_winner"):
        emit({"kernel_shape": name, "rows": n, "B": B, "shape": "Q4",
              **results[(name, "Q4")]})
    return results


def fsum_shape(torch, dev, seg, B: int, fcols, reps: int) -> dict:
    """K2 on ``fcols`` over ``seg``'s buckets against its plain version
    within 1e-9 of each bucket's sum of |x| (the atomics' order), NaN
    where the plain version has NaN; timed beside its bytes bound and one
    ``index_add_``, also behind a spin kernel (``dev_ms``) and on the
    host (``host_ms``)."""
    from spark_rapids_tpu_torch.ops import groupby_kernels as K

    n = seg.shape[0]
    got = K.bucket_float_sum(seg, B, fcols)
    exp = K.bucket_float_sum_plain(seg, B, fcols)
    absx = K.bucket_float_sum_plain(seg, B, [(d.abs(), v) for d, v in fcols])
    err = 0.0
    for g, e, ax in zip(got, exp, absx):
        both_nan = torch.isnan(g) & torch.isnan(e)
        diff = torch.where(both_nan, 0.0, (g - e).abs())
        if bool((torch.isnan(g) != torch.isnan(e)).any()) or bool(
                (diff > 1e-9 * torch.where(torch.isnan(ax), 0.0, ax)
                 + 1e-300).any()):
            raise AssertionError(f"bucket_float_sum B={B}, {len(fcols)} "
                                 "column(s): kernel != plain")
        err = max(err, float(diff.max()))
    res = {"max_abs_err": err, "replicas": K.plan_bucket_fsum(B, len(fcols))}
    live = (seg >= 0) & (seg < B)
    nbytes = int(K.bucket_float_sum_bytes(seg, B, fcols))
    fidx = torch.where(live, seg.long(), B)
    fvals = torch.stack([torch.where(v, d, 0.0) for d, v in fcols], 1)
    res.update({
        "ms": cuda_ms(torch, lambda: K.bucket_float_sum(seg, B, fcols),
                      reps),
        "dev_ms": dev_ms(torch, lambda: K.bucket_float_sum(seg, B, fcols),
                         reps),
        "host_ms": host_ms(torch, lambda: K.bucket_float_sum(seg, B, fcols),
                           reps),
        "plain_ms": cuda_ms(torch, lambda: K.bucket_float_sum_plain(
            seg, B, fcols), reps),
        "library_ms": cuda_ms(torch, lambda: torch.zeros(
            (B + 1, len(fcols)), dtype=torch.float64,
            device=dev).index_add_(0, fidx, fvals), reps),
        "bound_ms": bound_ms(nbytes),
    })
    return res


def sum_shape(torch, dev, seg, B: int, int_cols, cnt_cols,
              reps: int) -> dict:
    """K1 on ``int_cols`` (int64 sums) and ``cnt_cols`` (counts) over
    ``seg``'s buckets, held to its plain version exactly and timed beside
    its bytes bound and one ``index_add_``."""
    from spark_rapids_tpu_torch.ops import groupby_kernels as K

    n = seg.shape[0]
    live = (seg >= 0) & (seg < B)
    got_i, got_c = K.bucket_sum(seg, B, int_cols, cnt_cols)
    exp_i, exp_c = K.bucket_sum_plain(seg, B, int_cols, cnt_cols)
    for g, e in zip(got_i + got_c, exp_i + exp_c):
        if not torch.equal(g, e):
            raise AssertionError(f"bucket_sum B={B}: kernel != plain")
    L = len(int_cols) + len(cnt_cols)
    passes = K.plan_bucket_sum(B, len(int_cols), len(cnt_cols))
    nbytes = int(K.bucket_sum_bytes(seg, B, int_cols, cnt_cols))
    idx = torch.where(live, seg.long(), B)
    stacked = torch.stack([torch.where(v, d, 0) for d, v in int_cols]
                          + [v.long() for v in cnt_cols], 1)
    return {
        "max_abs_err": 0.0,
        "passes": [[lo, hi, "shared" if sh else "device"]
                   for lo, hi, sh in passes],
        "ms": cuda_ms(torch, lambda: K.bucket_sum(seg, B, int_cols,
                                                  cnt_cols), reps),
        "plain_ms": cuda_ms(torch, lambda: K.bucket_sum_plain(
            seg, B, int_cols, cnt_cols), reps),
        "library_ms": cuda_ms(torch, lambda: torch.zeros(
            (B + 1, L), dtype=torch.int64, device=dev).index_add_(
            0, idx, stacked), reps),
        "bound_ms": bound_ms(nbytes),
    }


def ordered_sum_shape(torch, np, dev, sv, sseg, B: int, reps: int,
                      dadd_ns: float) -> dict:
    """The ordered segment sum of ``sv`` over ``sseg``'s segments (rows
    sorted by segment): equal to numpy's serial ``bincount`` bit for bit
    and to its plain version within 1e-9 of each segment's sum of |x|;
    timed beside its bytes bound, its chain bound (the longest segment's
    dependent adds at ``dadd_ns``) and one ``index_add_``."""
    from spark_rapids_tpu_torch.ops import groupby_kernels as K

    n = sseg.shape[0]
    got = K.ordered_segment_sum(sv, sseg, B)
    exp = K.ordered_segment_sum_plain(sv, sseg, B)
    seg_h, sv_h = sseg.cpu().numpy(), sv.cpu().numpy()
    keep = (seg_h >= 0) & (seg_h < B)
    ref = np.bincount(seg_h[keep], weights=sv_h[keep], minlength=B)
    if not np.array_equal(got.cpu().numpy(), ref, equal_nan=True):
        raise AssertionError(f"ordered_segment_sum B={B}: not the serial "
                             "row-order sum")
    absx = K.ordered_segment_sum_plain(sv.abs(), sseg, B)
    diff = torch.where(torch.isnan(got) & torch.isnan(exp), 0.0,
                       (got - exp).abs())
    if bool((diff > 1e-9 * torch.nan_to_num(absx) + 1e-300).any()):
        raise AssertionError(f"ordered_segment_sum B={B}: kernel != plain")
    nbytes = int(K.ordered_segment_sum_bytes(sseg, B))
    longest = int(np.bincount(seg_h[keep], minlength=B).max())
    sidx = torch.where((sseg >= 0) & (sseg < B), sseg.long(), B)
    return {
        "max_abs_err": float(diff.max()),
        "ms": cuda_ms(torch, lambda: K.ordered_segment_sum(sv, sseg, B),
                      reps),
        "dev_ms": dev_ms(torch, lambda: K.ordered_segment_sum(sv, sseg, B),
                         reps),
        "plain_ms": cuda_ms(torch, lambda: K.ordered_segment_sum_plain(
            sv, sseg, B), reps),
        "library_ms": cuda_ms(torch, lambda: torch.zeros(
            B + 1, dtype=torch.float64, device=dev).index_add_(
            0, sidx, sv), reps),
        "bound_ms": bound_ms(nbytes),
        # the serial chain: the longest segment's dependent adds
        "bound_chain_ms": longest * dadd_ns * 1e-6,
        "longest_segment": longest,
        "segments": int((np.bincount(seg_h[keep], minlength=B) > 0).sum()),
        "dadd_ns": dadd_ns,
    }


@contextlib.contextmanager
def captured_calls(mod, name: str, keep, limit: int = 1):
    """Record the arguments of the first ``limit`` calls to ``mod.name``
    for which ``keep(*args)`` holds, in a list the block receives; each
    call still runs (and counts its launch). The recorded tensors outlive
    the run, so no site donates in the block (a donated batch's planes
    are released once its site has read them)."""
    from spark_rapids_tpu_torch.plugin import donation

    calls = []
    fn = getattr(mod, name)
    mask = donation.dispatch_mask

    def recording(*args):
        if len(calls) < limit and keep(*args):
            calls.append(args)
        return fn(*args)

    setattr(mod, name, recording)
    donation.dispatch_mask = lambda *a, **k: ()
    try:
        yield calls
    finally:
        setattr(mod, name, fn)
        donation.dispatch_mask = mask


def winner_shape(torch, dev, seg, B: int, op: str, word, reps: int) -> dict:
    """K3 on ``word`` (one order word per row) over ``seg``'s buckets,
    held to its plain version exactly and timed beside its bytes bound
    (the segment ids, each live row's word, the table) and one
    ``scatter_reduce_``."""
    from spark_rapids_tpu_torch.ops import groupby_kernels as K
    from spark_rapids_tpu_torch.ops.sort import SIGN64

    live = (seg >= 0) & (seg < B)
    got = K.bucket_winner(seg, B, op, word)
    exp = K.bucket_winner_plain(seg, B, op, word)
    if not torch.equal(got, exp):
        raise AssertionError(f"bucket_winner B={B}: kernel != plain")
    nbytes = int(K.bucket_winner_bytes(seg, B))
    idx = torch.where(live, seg.long(), B)
    sw = word ^ SIGN64
    init = (K.IDENT_MIN if op == "min" else K.IDENT_MAX) ^ SIGN64
    return {
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: K.bucket_winner(seg, B, op, word), reps),
        "dev_ms": dev_ms(torch, lambda: K.bucket_winner(seg, B, op, word),
                         reps),
        "plain_ms": cuda_ms(torch, lambda: K.bucket_winner_plain(
            seg, B, op, word), reps),
        "library_ms": cuda_ms(torch, lambda: torch.full(
            (B + 1,), init, dtype=torch.int64, device=dev
        ).scatter_reduce_(0, idx, sw, "a" + op), reps),
        "bound_ms": bound_ms(nbytes),
    }


def timed_once(torch, fn):
    """(milliseconds, result) of one call of ``fn``, CUDA events around
    it: for a call too slow to repeat."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def launch_device_ms(torch, fn, symbols, calls: int = 5) -> dict:
    """Device milliseconds a call of ``fn`` spends in each kernel whose
    name holds one of ``symbols`` (torch.profiler over ``calls`` calls,
    after one unprofiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return {k: sum(e.self_device_time_total for e in events
                   if k in e.key) / 1e3 / calls for k in symbols}


def _radix_check(torch, perm, seg, streams, got, want, what: str) -> float:
    """The RADIX kernel's outputs ``got`` against its plain version's
    ``want``: counts, integer sums, positions and winner rows exactly,
    the presence flags exactly, the NORMAL and BIG float sums within
    1e-12 of each segment's sum of |x| over the rows of that stream; all
    over the segments the live rows reach (the kernel writes no others).
    Returns the largest float difference."""
    cap = perm.shape[0]
    live = (seg >= 0) & (seg < cap)
    sid = torch.where(live, seg.long(), cap)
    k = int(sid[live].max()) + 1 if bool(live.any()) else 0
    if k == 0:
        return 0.0
    got = [tuple(x[:k] for x in g) for g in got]
    want = [tuple(x[:k] for x in w) for w in want]
    worst = 0.0
    for i, (s, g, w) in enumerate(zip(streams, got, want)):
        if s.kind != "fsum":
            if not torch.equal(g[0].to(torch.int64), w[0].to(torch.int64)):
                bad = int((g[0].to(torch.int64)
                           != w[0].to(torch.int64)).sum())
                raise AssertionError(f"{what}: stream {i} ({s.kind} "
                                     f"{s.op}) differs in {bad} segments")
            continue
        x = torch.where(s.valid, s.data.to(torch.float64), 0.0)[perm]
        big = x.abs() > 2.0 ** 500
        fin = torch.isfinite(x)
        for j, part in enumerate((torch.where(fin & ~big, x.abs(), 0.0),
                                  torch.where(fin & big,
                                              x.abs() * 2.0 ** -600, 0.0))):
            scale = torch.zeros(cap + 1, dtype=torch.float64,
                                device=x.device).index_add_(0, sid,
                                                            part)[:k]
            d = (g[j] - w[j]).abs()
            same = g[j] == w[j]
            if bool(((d > 1e-12 * scale) & ~same).any()):
                raise AssertionError(f"{what}: stream {i} float part {j} "
                                     "differs past 1e-12 of sum |x|")
            worst = max(worst, float(torch.where(same, 0.0, d).max()))
        if not torch.equal(g[2], w[2]):
            raise AssertionError(f"{what}: stream {i} flags differ")
    return worst


def _radix_subproblem(torch, perm, seg, streams, m: int):
    """The first ``m`` sorted rows of a captured call as a problem of its
    own (their columns gathered into a new row order, a seeded shuffle),
    plus a max and a min winner over each float column's order words:
    tied values then fall across small tiles."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import radix_bin as RB
    from spark_rapids_tpu_torch.ops import radix_kernels as RK

    dev = perm.device
    gen = torch.Generator(device="cpu").manual_seed(17)
    q = torch.randperm(m, generator=gen).to(dev)
    rows = perm[:m]
    new = []
    for s in streams:
        def moved(t):
            if t is None:
                return None
            out = torch.empty(m, dtype=t.dtype, device=dev)
            out[q] = t[rows]
            return out

        new.append(RK.Stream(s.kind, moved(s.data), moved(s.valid), s.op))
    for s in list(new):
        if s.kind == "fsum":
            for op in ("max", "min"):
                word = RB.order_word(s.data, s.valid, T.DOUBLE, op)
                new.append(RK.Stream("win", word, s.valid, op))
    return q, seg[:m].clone(), new


def radix_shape(torch, np, dev, perm, seg, streams, ref_tile: int,
                reps: int, what: str, forced_tile: int = 1000) -> dict:
    """The RADIX segment kernel on one call's arguments (captured from a
    query), held to its plain version (:func:`_radix_check`) and timed
    beside its bytes bound; the plain version's time is its one checking
    call. Then the first 2^17 sorted rows as a problem of their own, with
    winners over tied values, at a forced ``forced_tile``-row reference
    tile. ``library_ms``: one ``torch.segment_reduce`` sum over the first
    float stream already in sorted order, or where there is none over the
    first count or integer stream (in f64: the card refuses int64).
    ``launch_dev_ms``: the device time of each of the kernel's two
    launches."""
    from spark_rapids_tpu_torch.ops import radix_kernels as RK

    cap = perm.shape[0]
    got = RK.segment_reduce(perm, seg, streams, ref_tile)
    plain_ms, want = timed_once(torch, lambda: RK.segment_reduce_plain(
        perm, seg, streams, ref_tile))
    err = _radix_check(torch, perm, seg, streams, got, want, what)
    del got, want
    m = min(cap, 1 << 17)
    sp, ss, sst = _radix_subproblem(torch, perm, seg, streams, m)
    _radix_check(torch, sp, ss, sst,
                 RK.segment_reduce(sp, ss, sst, forced_tile),
                 RK.segment_reduce_plain(sp, ss, sst, forced_tile),
                 f"{what} at {forced_tile}-row tiles")
    live = (seg >= 0) & (seg < cap)
    nlive = int(live.sum())
    nseg = int(seg[:nlive].max()) + 1 if nlive else 0

    def run():
        return RK.segment_reduce(perm, seg, streams, ref_tile)

    # the library call: one segment_reduce sum over the first float
    # stream, else the first count or integer stream, already sorted, in
    # f64 (the call takes no int64 on the card)
    fs = next((s for s in streams if s.kind == "fsum"), None) or next(
        (s for s in streams if s.kind in ("count", "isum")), None)
    library_ms = library = None
    if fs is not None and nlive:
        valid = (torch.ones(cap, dtype=torch.bool, device=perm.device)
                 if fs.valid is None else fs.valid)
        data = valid if fs.kind == "count" else fs.data
        sv = torch.where(valid, data.to(torch.float64), 0.0)[perm[:nlive]]
        lengths = torch.bincount(seg[:nlive].long(), minlength=nseg)
        library_ms = cuda_ms(torch, lambda: torch.segment_reduce(
            sv, "sum", lengths=lengths), reps)
        library = f"torch.segment_reduce sum of one sorted {fs.kind} stream"
    nbytes = RK.bound_bytes(perm, streams, nlive, nseg)
    # the kernel gathers each distinct column and validity at the
    # permutation: one 32-byte sector a live row for each, where the
    # sorted rows are scattered in the original order
    gathers = len(RK.distinct_inputs(streams))
    sectors = nlive * (32 * gathers + perm.element_size() + 4)
    return {"max_abs_err": err, "ms": cuda_ms(torch, run, reps),
            "dev_ms": dev_ms(torch, run, reps),
            "host_ms": host_ms(torch, run, reps), "plain_ms": plain_ms,
            "launch_dev_ms": launch_device_ms(torch, run, KERNEL_SYMBOLS[-2:]),
            "library_ms": library_ms, "library": library,
            "bound_ms": bound_ms(nbytes), "bytes": nbytes,
            "bound_sectors_ms": bound_ms(sectors), "rows": cap,
            "segments": nseg, "streams": [s.kind for s in streams],
            "ref_tile": ref_tile, "forced_tile_checked": forced_tile}


# ---------------------------------------------------------------------------
# query phase
# ---------------------------------------------------------------------------
def _batches(np, torch, schema, arrays, valids, nb, dev):
    from spark_rapids_tpu_torch.columnar import batch_from_host_arrays

    n = arrays[0].shape[0]
    per = n // nb
    out = []
    for i in range(nb):
        s = slice(i * per, (i + 1) * per)
        out.append(batch_from_host_arrays(
            schema, [a[s] for a in arrays], [v[s] for v in valids], per, per,
            dev))
    return out


def _padded_batch(np, torch, schema, arrays, valids, dev):
    """One batch of all the rows at their capacity bucket (the next power
    of two), padding rows dead, as the engine's own batches are. A string
    column's array is its (offsets (n+1,), chars) pair."""
    from spark_rapids_tpu_torch.columnar import (batch_from_host_arrays,
                                                 choose_capacity)

    n = valids[0].shape[0]
    cap = choose_capacity(n)

    def pad(a):
        if isinstance(a, tuple):
            off, chars = a  # the pool padded to its bucket, as uploads are
            pool = np.zeros(choose_capacity(max(1, chars.size)), np.uint8)
            pool[:chars.size] = chars
            return (np.concatenate([off, np.full(cap - n, off[-1])]), pool)
        return np.concatenate([a, np.zeros(cap - n, a.dtype)])

    return batch_from_host_arrays(schema, [pad(a) for a in arrays],
                                  [pad(v) for v in valids], n, cap, dev)


def _run(torch, plan_root, conf):
    """collect() rows and the wall milliseconds, device work included."""
    from spark_rapids_tpu_torch.exec import ColumnarToRowExec

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    rows = ColumnarToRowExec(conf, plan_root).collect()
    sync()
    return rows, (time.perf_counter() - t0) * 1e3


def _timed(torch, fn) -> float:
    """Wall milliseconds of ``fn()``, device work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _close(got, exp, scale, rtol=1e-9):
    return abs(got - exp) <= rtol * scale + 1e-12


def query_phase(torch, np, dev, log2_rows: int, nbatches: int,
                profile: bool = False, reps: int = 20):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.ops import radix_kernels as RK
    from spark_rapids_tpu_torch.ops.hashing import murmur3
    from spark_rapids_tpu_torch.expr.values import ColV

    n = 1 << log2_rows
    rng = np.random.default_rng(42)
    k = rng.integers(0, 64, n).astype(np.int32)
    a = rng.integers(-(10**6), 10**6, n).astype(np.int64)
    b = rng.normal(size=n)
    b_null = rng.random(n) < 0.05
    b_val = np.where(b_null, 0.0, b)
    schema = schema_of(k=T.INT, a=T.LONG, b=T.DOUBLE)
    ones = np.ones(n, bool)
    batches = _batches(np, torch, schema, [k, a, b_val], [ones, ones, ~b_null],
                       nbatches, dev)
    approx = RapidsConf({"spark.rapids.tpu.sql.variableFloatAgg.enabled":
                         True})
    exact = RapidsConf({})
    report = []
    per_query = {}

    def drive(plan_root, conf):
        """One path: the counts set to 0 just before it, read just after."""
        reset_launches()
        rows, ms = _run(torch, plan_root, conf)
        return rows, ms, launches()

    # --- Q1: the bench query ----------------------------------------------
    def q1_plan(conf):
        return q1_over(conf, InMemoryScanExec(conf, [batches], schema))

    m = a >= 0
    mb = m & ~b_null
    s_exp = np.bincount(k[m], weights=(2 * a[m]).astype(np.float64),
                        minlength=64)
    c_exp = np.bincount(k[mb], minlength=64)
    bsum = np.bincount(k[mb], weights=b[mb], minlength=64)
    babs = np.bincount(k[mb], weights=np.abs(b[mb]), minlength=64)
    groups = set(np.unique(k[m]).tolist())

    def check_q1(rows, what, rtol=1e-9):
        got = {r[0]: r[1:] for r in rows}
        if set(got) != groups:
            raise AssertionError(f"{what}: group set differs from the "
                                 "oracle")
        for g, (s, mean, c) in got.items():
            if s != int(s_exp[g]) or c != int(c_exp[g]):
                raise AssertionError(f"{what} group {g}: {s},{c} != "
                                     f"{int(s_exp[g])},{int(c_exp[g])}")
            if not _close(mean, bsum[g] / c_exp[g], babs[g] / c_exp[g],
                          rtol):
                raise AssertionError(f"{what} group {g}: avg {mean} != "
                                     f"{bsum[g] / c_exp[g]}")

    agg = q1_plan(approx)
    rows, ms, per_query["Q1"] = drive(agg, approx)
    check_q1(rows, "Q1")
    report.append({"query": "Q1", "rows": len(rows), "wall_ms": ms,
                   "strategy": agg._strategy_choice[0],
                   "launches": per_query["Q1"]})
    q1p_phase(torch, np, dev, k, a, b_val, b_null, schema, report, per_query)

    # --- Q1r, Q1m, Q1s: Q1 under forced RADIX, MATMUL and SORT: RADIX on
    # the RADIX kernel, one launch per partial and one in the merge;
    # MATMUL's f32 limb products (its float sums within the hi/lo
    # contract, rtol 1e-4); SORT's prefix differences with the float sum
    # on the ordered sum -------------------------------------------------
    for q, tier, rtol in (("Q1r", "RADIX", 1e-9), ("Q1m", "MATMUL", 1e-4),
                          ("Q1s", "SORT", 1e-9)):
        conf = RapidsConf({"spark.rapids.tpu.sql.variableFloatAgg.enabled":
                           True, "spark.rapids.tpu.sql.agg.strategy": tier})
        agg = q1_plan(conf)
        rows, ms, per_query[q] = drive(agg, conf)
        check_q1(rows, q, rtol)
        c = per_query[q]
        want = {"Q1r": {"radix_segment_reduce": nbatches + 1},
                "Q1m": {},
                "Q1s": {"ordered_segment_sum": nbatches + 1}}[q]
        if {name: v for name, v in c.items() if v} != want:
            raise AssertionError(f"{q}: launches {c}, expected {want}")
        report.append({"query": q, "rows": len(rows), "wall_ms": ms,
                       "strategy": agg._strategy_choice[0],
                       "launches": c})

    # --- Q2: min/max/first/last on the direct tier ------------------------
    def q2_plan():
        return TpuHashAggregateExec(exact, [col("k")], [
            A.agg(A.Min(col("b")), "mn"), A.agg(A.Max(col("a")), "mx"),
            A.agg(A.First(col("a")), "f"), A.agg(A.Last(col("b")), "l")],
            InMemoryScanExec(exact, [batches], schema))

    agg = q2_plan()
    rows, ms, per_query["Q2"] = drive(agg, exact)
    mn_exp = np.full(64, np.inf)
    np.minimum.at(mn_exp, k[~b_null], b[~b_null])
    mx_exp = np.full(64, np.iinfo(np.int64).min)
    np.maximum.at(mx_exp, k, a)
    rows_idx = np.arange(n)
    first_idx = np.full(64, n)
    np.minimum.at(first_idx, k, rows_idx)
    last_idx = np.full(64, -1)
    np.maximum.at(last_idx, k, rows_idx)
    uniq = np.flatnonzero(last_idx >= 0)
    first_idx, last_idx = first_idx[uniq], last_idx[uniq]
    got = {r[0]: r[1:] for r in rows}
    if set(got) != set(uniq.tolist()):
        raise AssertionError("Q2: group set differs from the oracle")
    for g, fi, li in zip(uniq.tolist(), first_idx, last_idx):
        mn, mx, f, last = got[g]
        exp_last = None if b_null[li] else float(b[li])
        if (mn != mn_exp[g] or mx != int(mx_exp[g]) or f != int(a[fi])
                or last != exp_last):
            raise AssertionError(f"Q2 group {g}: {got[g]} != "
                                 f"{(mn_exp[g], mx_exp[g], a[fi], exp_last)}")
    report.append({"query": "Q2", "rows": len(rows), "wall_ms": ms,
                   "strategy": agg._strategy_choice[0],
                   "launches": per_query["Q2"]})

    # --- Q3: int64 keys over the whole range: the murmur3 hash tier -------
    n3 = 1 << (log2_rows - 2)
    tiers = (128, 1024, 8192)
    for seed in range(1000):
        vals = np.random.default_rng(seed).integers(
            np.iinfo(np.int64).min, np.iinfo(np.int64).max, 40,
            dtype=np.int64)
        kv = torch.from_numpy(vals)
        h = murmur3([ColV(kv, torch.ones(40, dtype=torch.bool))],
                    [T.LONG]).long()
        answering = next((B for B in tiers
                          if len(set((h & (B - 1)).tolist())) == 40), None)
        if answering is not None and len(set(vals.tolist())) == 40:
            break
    else:
        raise AssertionError("Q3: no seed below 1000 gives a hash tier")
    r3 = np.random.default_rng(seed + 1)
    key3 = vals[r3.integers(0, 40, n3)]
    a3 = r3.integers(-(10**6), 10**6, n3).astype(np.int64)
    schema3 = schema_of(g=T.LONG, a=T.LONG)
    one3 = np.ones(n3, bool)
    b3 = _batches(np, torch, schema3, [key3, a3], [one3, one3], 1, dev)
    agg = TpuHashAggregateExec(exact, [col("g")], [
        A.agg(A.Sum(col("a")), "s"), A.agg(A.Count(None), "c")],
        InMemoryScanExec(exact, [b3], schema3))
    rows, ms, per_query["Q3"] = drive(agg, exact)
    inv = np.searchsorted(np.sort(vals), key3)
    order = np.sort(vals)
    s3 = np.bincount(inv, weights=a3.astype(np.float64), minlength=40)
    c3 = np.bincount(inv, minlength=40)
    got = {r[0]: r[1:] for r in rows}
    if set(got) != set(vals.tolist()):
        raise AssertionError("Q3: group set differs from the oracle")
    for i, g in enumerate(order.tolist()):
        if got[g] != (int(s3[i]), int(c3[i])):
            raise AssertionError(f"Q3 group {g}: {got[g]} != "
                                 f"{(int(s3[i]), int(c3[i]))}")
    # one bucket_sum launch per hash tier tried: the answering tier is the
    # count-th of (128, 1024, 8192)
    tried = per_query["Q3"]["bucket_sum"]
    if tried < 1 or tried > 3 or tiers[tried - 1] != answering:
        raise AssertionError(f"Q3: {tried} hash tier(s) tried, expected the "
                             f"B={answering} tier to answer")
    report.append({"query": "Q3", "rows": len(rows), "wall_ms": ms,
                   "strategy": agg._strategy_choice[0], "seed": seed,
                   "answering_tier_B": answering,
                   "launches": per_query["Q3"]})

    # --- Q4: 2^20 distinct keys: the sort fallback -------------------------
    n4 = 1 << (log2_rows - 2)
    r4 = np.random.default_rng(4)
    ng = 1 << (log2_rows - 6)
    if ng <= 8192:
        # more groups than the widest hash tier has buckets is what makes
        # the sort fallback answer (pigeonhole), so Q4 needs > 8192 groups
        raise ValueError("--log2-rows must be at least 20")
    key4 = r4.permutation(np.concatenate([
        np.arange(ng, dtype=np.int32),
        r4.integers(0, ng, n4 - ng).astype(np.int32)]))
    a4 = r4.integers(-(10**6), 10**6, n4).astype(np.int64)
    b4 = r4.normal(size=n4)
    bn4 = r4.random(n4) < 0.05
    schema4 = schema_of(g=T.INT, a=T.LONG, b=T.DOUBLE)
    one4 = np.ones(n4, bool)
    b4s = _batches(np, torch, schema4, [key4, a4, np.where(bn4, 0.0, b4)],
                   [one4, one4, ~bn4], 1, dev)
    agg = TpuHashAggregateExec(exact, [col("g")], [
        A.agg(A.Sum(col("a")), "s"), A.agg(A.Count(col("b")), "c"),
        A.agg(A.Max(col("b")), "mx")],
        InMemoryScanExec(exact, [b4s], schema4))
    # the sort fallback's RADIX reduction: its arguments are recorded for
    # the kernel check at Q4's shape (2^24 rows, 2^20 segments)
    with captured_calls(RK, "segment_reduce", lambda *a: True) as calls:
        rows, ms, per_query["Q4"] = drive(agg, exact)
    s4 = np.bincount(key4, weights=a4.astype(np.float64), minlength=ng)
    c4 = np.bincount(key4[~bn4], minlength=ng)
    mx4 = np.full(ng, -np.inf)
    np.maximum.at(mx4, key4[~bn4], b4[~bn4])
    if len(rows) != ng:
        raise AssertionError(f"Q4: {len(rows)} groups, expected {ng}")
    for g, s, c, mx in rows:
        exp_mx = None if c4[g] == 0 else float(mx4[g])
        if s != int(s4[g]) or c != int(c4[g]) or mx != exp_mx:
            raise AssertionError(f"Q4 group {g}: {(s, c, mx)} != "
                                 f"{(int(s4[g]), int(c4[g]), exp_mx)}")
    if (per_query["Q4"]["bucket_sum"] != 3
            or per_query["Q4"]["radix_segment_reduce"] != 1
            or per_query["Q4"]["ordered_segment_sum"]):
        raise AssertionError("Q4: expected all three hash tiers to collide "
                             "before the sort fallback, reduced on the "
                             f"RADIX kernel: {per_query['Q4']}")
    report.append({"query": "Q4", "rows": len(rows), "wall_ms": ms,
                   "strategy": agg._strategy_choice[0],
                   "answered_by": "sort fallback",
                   "launches": per_query["Q4"]})
    radix_q4 = radix_shape(torch, np, dev, *calls[0], reps, "Q4")
    emit({"kernel_shape": "radix_segment_reduce", "path": "Q4",
          **radix_q4})
    del calls

    # --- Q5: exact float sum, order-preserving and deterministic: the
    # path's counts are those of its first run; the second run is only
    # compared with it ------------------------------------------------------
    results = []
    for run in range(2):
        agg = TpuHashAggregateExec(exact, [col("k")], [
            A.agg(A.Sum(col("b")), "s")],
            InMemoryScanExec(exact, [batches], schema))
        rows, ms, launched = drive(agg, exact)
        if run == 0:
            per_query["Q5"], q5_ms = launched, ms
        results.append(dict(rows))
    if results[0] != results[1]:
        raise AssertionError("Q5: exact float sums differ between two runs")
    nb = ~b_null
    s5 = np.bincount(k[nb], weights=b[nb], minlength=64)
    a5 = np.bincount(k[nb], weights=np.abs(b[nb]), minlength=64)
    for g, s in results[0].items():
        if not _close(s, s5[g], a5[g], rtol=1e-12):
            raise AssertionError(f"Q5 group {g}: {s} != {s5[g]}")
    report.append({"query": "Q5", "rows": len(rows), "wall_ms": q5_ms,
                   "strategy": agg._strategy_choice[0],
                   "launches": per_query["Q5"]})

    expect = {"Q1": ("bucket_sum", "bucket_float_sum"),
              "Q2": ("bucket_sum", "bucket_winner"),
              "Q3": ("bucket_sum", "bucket_winner"),
              "Q4": ("bucket_sum", "radix_segment_reduce"),
              "Q5": ("ordered_segment_sum",)}
    for q, names in expect.items():
        for name in names:
            if per_query[q][name] <= 0:
                raise AssertionError(f"{q} did not launch {name}")
    for line in report:
        emit(line)
    if profile:
        profile_q1(torch, approx, batches, schema, n)
        # Q2: k, a, b and their validity read once
        profile_plan(torch, "Q2", q2_plan, exact, n, n * (4 + 8 + 8 + 2))
        # Q5: each input plane read once (k, b and their validity)
        profile_plan(torch, "Q5", lambda: TpuHashAggregateExec(
            exact, [col("k")], [A.agg(A.Sum(col("b")), "s")],
            InMemoryScanExec(exact, [batches], schema)), exact, n,
            n * (4 + 8 + 2))
    return per_query, {("radix_segment_reduce", "Q4"): radix_q4}


#: both fused aggregate routes off: the streaming updates and merge
FUSION_OFF = {"spark.rapids.tpu.sql.stageFusion": "OFF",
              "spark.rapids.tpu.sql.agg.fusedPlan": "OFF"}
#: Q1p: Q1's first 2^24 rows (the fused plan's row guard) in 8 batches
Q1P_LOG2_ROWS = 24
Q1P_BATCHES = 8
Q1P_FAULT = "TpuHashAggregateExec@1"


def q1p_phase(torch, np, dev, k, a, b_val, b_null, schema, report,
              per_query):
    """Q1p: Q1's query (AUTO + variableFloatAgg) over the first 2^24 rows
    of Q1's table as 8 in-memory batches, the most the fused plan's row
    guard admits, run three ways, each checked against a numpy oracle:
    under AUTO (the fused plan: every update, the padded merge and the
    result projection in one call), with ``sql.agg.fusedPlan=OFF`` (the
    streaming updates and merge) and under AUTO with an ``oom`` fault at
    the plan site (the fallback to the streaming path). Q1p-nn and
    Q1p-nn-noelide (twice each, alternating) run AUTO with k and a
    declared non-null, with ``analysis.nullElision`` on and off: the
    elision's reading, its keys, sums and counts the same. Each reports
    its cold and three warm walls, the peak device memory above what the
    batches hold, its route and its launches: K1 and K2 once per batch
    and once in the merge on every route, never a plain version."""
    import gc

    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.conf import ANALYSIS_NULL_ELISION as \
        NULL_ELISION
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.types import StructField, StructType
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.memory import retry as R

    m = min(k.shape[0], 1 << Q1P_LOG2_ROWS)
    k, a, b_val, b_null = k[:m], a[:m], b_val[:m], b_null[:m]
    ones = np.ones(m, bool)
    batches = _batches(np, torch, schema, [k, a, b_val],
                       [ones, ones, ~b_null], Q1P_BATCHES, dev)
    keep = a >= 0
    kb = keep & ~b_null
    s_exp = np.bincount(k[keep], weights=(2 * a[keep]).astype(np.float64),
                        minlength=64)
    c_exp = np.bincount(k[kb], minlength=64)
    bsum = np.bincount(k[kb], weights=b_val[kb], minlength=64)
    babs = np.bincount(k[kb], weights=np.abs(b_val[kb]), minlength=64)
    groups = set(np.unique(k[keep]).tolist())

    def check(rows, what):
        got = {r[0]: r[1:] for r in rows}
        if set(got) != groups:
            raise AssertionError(f"{what}: group set differs from the "
                                 "oracle")
        for g, (sv, mean, c) in got.items():
            if sv != int(s_exp[g]) or c != int(c_exp[g]) or not _close(
                    mean, bsum[g] / c_exp[g], babs[g] / c_exp[g]):
                raise AssertionError(f"{what} group {g}: {sv}, {mean}, {c}")

    # the same batches with k and a declared non-null (their planes hold
    # no null): the null elision's reading, on and off
    nn_schema = StructType((StructField("k", T.INT, False),
                            StructField("a", T.LONG, False),
                            schema.fields[2]))

    def plan(conf, sch=schema):
        scan = InMemoryScanExec(conf, [batches], sch)
        filt = TpuFilterExec(conf, E.GreaterThanOrEqual(col("a"), lit(0)),
                             scan)
        proj = TpuProjectExec(conf, [col("k"), E.Alias(
            E.Multiply(col("a"), lit(2)), "a2"), col("b")], filt)
        return TpuHashAggregateExec(conf, [col("k")], [
            A.agg(A.Sum(col("a2")), "s"), A.agg(A.Average(col("b")), "m"),
            A.agg(A.Count(col("b")), "c")], proj)

    vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
           "spark.rapids.tpu.memory.oomRetry.backoffMs": 0}
    no_elide = {"spark.rapids.tpu.sql.analysis.nullElision.enabled": False}
    runs = (("Q1p", vfa, None, {"plan": 1}, schema),
            ("Q1p-off", {**vfa, "spark.rapids.tpu.sql.agg.fusedPlan":
                         "OFF"}, None, {"update": 1}, schema),
            ("Q1p-oom", {**vfa, "spark.rapids.tpu.test.faults.oom":
                         Q1P_FAULT}, Q1P_FAULT, {"plan": 1, "update": 1},
             schema),
            ("Q1p-nn", vfa, None, {"plan": 1}, nn_schema),
            ("Q1p-nn-noelide", {**vfa, **no_elide}, None, {"plan": 1},
             nn_schema),
            ("Q1p-nn2", vfa, None, {"plan": 1}, nn_schema),
            ("Q1p-nn-noelide2", {**vfa, **no_elide}, None, {"plan": 1},
             nn_schema))
    want = {"bucket_sum": Q1P_BATCHES + 1,
            "bucket_float_sum": Q1P_BATCHES + 1}
    nn_rows = []
    for q, settings, fault, route, sch in runs:
        conf = RapidsConf(settings)
        walls, peaks, counts, stats = [], [], None, {}
        for _ in range(4):
            agg = plan(conf, sch)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            R.reset_stats()
            if fault:
                faults.install(conf)
            try:
                reset_launches()
                rows, ms = _run(torch, agg, conf)
                c = launches()
            finally:
                faults.uninstall()
            peaks.append(torch.cuda.max_memory_allocated() - before)
            check(rows, q)
            if c.agg_route != route or {n: v for n, v in c.items()
                                        if v} != want:
                raise AssertionError(f"{q}: route {c.agg_route}, "
                                     f"launches {dict(c)}")
            stats = R.stats().get("TpuHashAggregateExec", {})
            if bool(fault) != (stats.get("fused_plan_fallback") == 1):
                raise AssertionError(f"{q}: retry stats {stats}")
            walls.append(ms)
            counts = c
        if sch is nn_schema:
            # elision is bit for bit: every run gives the same keys, sums
            # and counts (the means sum through K2's atomics, whose order
            # varies run to run: check() holds them to the oracle)
            exact = sorted((r[0], r[1], r[3]) for r in rows)
            nn_rows.append(exact)
            if exact != nn_rows[0]:
                raise AssertionError(f"{q}: keys, sums or counts differ "
                                     "from Q1p-nn's")
        per_query[q] = counts
        report.append({"query": q, "rows": m, "batches": Q1P_BATCHES,
                       "cold_wall_ms": walls[0], "warm_wall_ms": walls[1:],
                       "peak_bytes_above_inputs": peaks,
                       "input_bytes": sum(
                           c.data.numel() * c.data.element_size()
                           + c.validity.numel() for bt in batches
                           for c in bt.columns),
                       "strategy": agg._strategy_choice[0],
                       "fault_spec": fault, "retry_stats": stats,
                       "non_null_columns": [f.name for f in sch.fields
                                            if not f.nullable],
                       "null_elision": conf.get(NULL_ELISION),
                       "launches": counts})


def profile_q1(torch, conf, batches, schema, n):
    """Q1 once more under torch.profiler (:func:`profile_plan`); its
    bytes bound reads each input plane once."""
    from spark_rapids_tpu_torch.exec import InMemoryScanExec

    profile_plan(torch, "Q1", lambda: q1_over(conf, InMemoryScanExec(
        conf, [batches], schema)), conf, n, n * (4 + 8 + 8 + 3))


def profile_plan(torch, name, plan, conf, rows, nbytes, sort_kernels=()):
    """:func:`profile_run` of one query collected through a fresh exec
    tree (``plan()`` builds it)."""
    profile_run(torch, name, lambda: _run(torch, plan(), conf)[1], rows,
                nbytes, sort_kernels)


def profile_run(torch, name, once, rows, nbytes, sort_kernels=(),
                unprofiled: int = 3):
    """``once()`` (which runs a query and returns its wall ms)
    ``unprofiled`` times, then once under torch.profiler: device time by kernel,
    the device's busy and idle share of the wall time, beside the
    query's bytes bound (``nbytes`` at the card's peak rate); with
    ``sort_kernels`` (name substrings) also the device time of the
    kernels that match them (``sort_device_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = [once() for _ in range(unprofiled)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = once()
    # kernel rows only: an operator row (aten::cat) carries the device
    # time of the kernels it launched, which have rows of their own
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    ours = {k: sum(e.self_device_time_total for e in events
                   if k in e.key) / 1e3 for k in KERNEL_SYMBOLS}
    emit({"profile": name, "rows": rows, "wall_ms_unprofiled": walls,
          "wall_ms_profiled": wall, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1 - busy_us / 1e3 / wall,
          "kernel_device_ms": {k: v for k, v in ours.items() if v},
          **({"sort_device_ms": sum(
              e.self_device_time_total for e in events
              if any(k in e.key for k in sort_kernels)) / 1e3}
             if sort_kernels else {}),
          "bound_ms": bound_ms(nbytes),
          "top": [{"name": e.key[:80], "calls": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in top]})


# ---------------------------------------------------------------------------
# join kernel phase (K4)
# ---------------------------------------------------------------------------
def _key_words(torch, keys, valid):
    """The join's radix key words of an int64 key column."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr.values import ColV
    from spark_rapids_tpu_torch.ops import join as J

    words, _ = J.radix_key_words([ColV(keys, valid)], [T.LONG])
    return words


def _sorted_build(torch, np, rng, dev, nb, bcount, card):
    """``nb`` build rows of int64 keys from [0, card), duplicates
    included, as the join exec leaves them: the joinable prefix
    [0, bcount) sorted by key words, garbage past it."""
    from spark_rapids_tpu_torch.ops import join_kernels as JK
    from spark_rapids_tpu_torch.ops.sort import SIGN64

    keys = torch.from_numpy(rng.integers(0, card, nb).astype(np.int64)).to(
        dev)
    words = _key_words(torch, keys, torch.ones(nb, dtype=torch.bool,
                                               device=dev))
    order = torch.argsort(JK.pack_key(words)[:bcount] ^ SIGN64, stable=True)
    for w in words:
        w[:bcount] = w[:bcount][order]
    return words


def _check_probe(torch, got, exp, what):
    for g, e, part in zip(got, exp, ("lo", "hi")):
        if not torch.equal(g, e):
            bad = int((g != e).sum())
            raise AssertionError(f"probe_ranges {what}: {part} differs on "
                                 f"{bad} rows")


def _probe_shape(torch, np, dev, rng, m, nb, bcount, bcard, pcard, dead,
                 reps):
    """K4 on ``m`` probe rows (2-word int64 keys from [0, pcard), a
    ``dead`` share dead) against ``nb`` build rows whose first ``bcount``
    are sorted keys from [0, bcard), duplicates included; checked and
    timed by :func:`probe_timed`."""
    bw = _sorted_build(torch, np, rng, dev, nb, bcount, bcard)
    fk = torch.from_numpy(rng.integers(0, pcard, m).astype(np.int64)).to(dev)
    live = torch.from_numpy(rng.random(m) >= dead).to(dev)
    pw = _key_words(torch, fk, live)
    res = probe_timed(torch, bw, bcount, pw, live, reps)
    emit({"kernel_shape": "probe_ranges", "probe_rows": m, "build_rows": nb,
          "build_count": bcount, "words": len(pw), **res})
    return res


def probe_timed(torch, bw, bcount: int, pw, live, reps: int) -> dict:
    """K4 on probe words ``pw`` (``live`` rows) against the sorted build
    words ``bw`` (joinable prefix ``bcount``), held against the
    ``searchsorted``-derived ranges on every row (counts equal, lo where
    count > 0, (0, 0) elsewhere) and against the plain version on 2^16
    probe rows x the whole build; timed beside its bytes bound, the plain
    version (on the 2^16-row sample: in full it is an O(m x nb) mask) and
    two ``torch.searchsorted`` calls."""
    from spark_rapids_tpu_torch.ops import join_kernels as JK
    from spark_rapids_tpu_torch.ops.sort import SIGN64

    m, nb = pw[0].shape[0], bw[0].shape[0]
    got = JK.probe_ranges(bw, bcount, pw, live)
    bs = (JK.pack_key(bw)[:bcount] ^ SIGN64).contiguous()
    ps = (JK.pack_key(pw) ^ SIGN64).contiguous()

    def library():
        return (torch.searchsorted(bs, ps),
                torch.searchsorted(bs, ps, right=True))

    left, right = library()
    cnt = torch.where(live, right - left, 0).to(torch.int32)
    lo = torch.where(cnt > 0, left.to(torch.int32), 0)
    _check_probe(torch, got, (lo, lo + cnt), f"{m} x {nb} vs searchsorted")

    sample = min(m, 1 << 16)
    sw = [w[:sample] for w in pw]
    exp = JK.probe_ranges_plain(bw, bcount, sw, live[:sample])
    _check_probe(torch, [g[:sample] for g in got], exp,
                 f"{m} x {nb} vs plain (sample)")

    # the bound counts what the probe needs (JK.probe_ranges_bytes). The
    # wrapper's ABI moves each probe word as an int64 (8 bytes):
    # bound_abi_ms counts that.
    nw = len(pw)
    nbytes = JK.probe_ranges_bytes(m, nw, nb)
    nbytes_abi = m * (8 * nw + 1 + 8) + 8 * nb
    return {
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: JK.probe_ranges(bw, bcount, pw, live),
                      reps),
        "dev_ms": dev_ms(torch, lambda: JK.probe_ranges(bw, bcount, pw,
                                                        live), reps),
        "plain_ms": cuda_ms(torch, lambda: JK.probe_ranges_plain(
            bw, bcount, sw, live[:sample]), max(1, reps // 10)),
        "plain_rows": sample,
        "library_ms": cuda_ms(torch, library, reps),
        "bound_ms": bound_ms(nbytes),
        "bound_abi_ms": bound_ms(nbytes_abi),
        "log2_buckets": JK.plan_probe(nb),
        "matched_share": float((cnt > 0).float().mean()),
    }


def join_kernel_phase(torch, np, dev, m: int, dim_rows: int, reps: int):
    """K4 at the bench join's shape (``m`` probe rows over 1.5x the dim's
    key range, 5% dead, against a build of choose_capacity(dim_rows) rows
    with duplicate keys) and at Q8's (m / 8 probe rows over [0, 150 000),
    2% dead, against choose_capacity(m / 128) rows of keys from
    [0, 100 000)); see :func:`_probe_shape`. Also held against the plain
    version in full at 2^20 x 2^13, on a build where one key holds most
    rows (the kernel's search path), and with a device build count below
    the build's rows whose garbage tail holds the probe keys. Returns
    the bench shape's and Q8's numbers."""
    from spark_rapids_tpu_torch.columnar import choose_capacity
    from spark_rapids_tpu_torch.ops import join_kernels as JK

    rng = np.random.default_rng(17)
    bench = _probe_shape(torch, np, dev, rng, m, choose_capacity(dim_rows),
                         dim_rows, dim_rows, dim_rows * 3 // 2, 0.05, reps)
    m8, d8 = max(1, m // 8), max(1, m // 128)
    q8 = _probe_shape(torch, np, dev, rng, m8, choose_capacity(d8), d8,
                      100_000, 150_000, 0.02, reps)

    m2, nb2 = min(m, 1 << 20), 1 << 13
    bw2 = _sorted_build(torch, np, rng, dev, nb2, nb2 - 321, nb2)
    fk2 = torch.from_numpy(rng.integers(0, nb2 * 3 // 2, m2).astype(
        np.int64)).to(dev)
    live2 = torch.from_numpy(rng.random(m2) >= 0.05).to(dev)
    pw2 = _key_words(torch, fk2, live2)
    _check_probe(torch, JK.probe_ranges(bw2, nb2 - 321, pw2, live2),
                 JK.probe_ranges_plain(bw2, nb2 - 321, pw2, live2),
                 "vs plain (2^20 x 2^13)")

    # one key over many buckets' worth of rows: 2^17 rows of 5 keys, key
    # 2 holding 90% (the kernel's search path)
    nb3 = 1 << 17
    k3 = np.sort(np.where(rng.random(nb3) < 0.9, 2,
                          rng.integers(0, 5, nb3))).astype(np.int64)
    ones = torch.ones(nb3, dtype=torch.bool, device=dev)
    bw3 = _key_words(torch, torch.from_numpy(k3).to(dev), ones)
    fk3 = torch.from_numpy(rng.integers(-1, 6, m2).astype(np.int64)).to(dev)
    pw3 = _key_words(torch, fk3, live2)
    _check_probe(torch, JK.probe_ranges(bw3, nb3, pw3, live2),
                 JK.probe_ranges_plain(bw3, nb3, pw3, live2),
                 "vs plain (one key, most rows)")

    # a device build count below nb: the tail past it is garbage that
    # holds the probe keys, and must not be read
    bc4 = nb2 - 1000
    bw4 = _sorted_build(torch, np, rng, dev, nb2, bc4, nb2)
    tail = rng.integers(0, nb2, nb2 - bc4).astype(np.int64)
    tail_w = _key_words(torch, torch.from_numpy(tail).to(dev),
                        torch.ones(nb2 - bc4, dtype=torch.bool, device=dev))
    for w, t in zip(bw4, tail_w):
        w[bc4:] = t
    fk4 = torch.from_numpy(np.concatenate([tail, rng.integers(
        0, nb2, m2 - tail.size)]).astype(np.int64)).to(dev)
    pw4 = _key_words(torch, fk4, live2)
    bc_dev = torch.tensor(bc4, dtype=torch.int32, device=dev)
    _check_probe(torch, JK.probe_ranges(bw4, bc_dev, pw4, live2),
                 JK.probe_ranges_plain(bw4, bc4, pw4, live2),
                 "vs plain (device build count, keys in the tail)")
    return bench, q8


# ---------------------------------------------------------------------------
# join queries (Q6-Q8)
# ---------------------------------------------------------------------------
def _reduce_join(torch, plan_root):
    """A join's output reduced on the card: rows, and per column the
    valid count and the sum of valid values (exact int64; a string
    column's: the sum of its rows' bytes)."""
    ncols = len(plan_root.output_schema.fields)
    rows = 0
    acc = None
    for b in plan_root.execute_columnar():
        rows += b.num_rows
        part = torch.stack(
            [t for c in b.columns for t in (
                c.validity.sum(dtype=torch.int64),
                _string_sum(torch, c, b.num_rows) if c.is_string else
                torch.where(c.validity, c.data.to(torch.int64), 0).sum())])
        acc = part if acc is None else acc + part
    vals = [0] * (2 * ncols) if acc is None else acc.tolist()
    return (rows,) + tuple(vals)


def _join_oracle(np, fk, fv, fnull, dk, dv, dnull, how, thresh=None,
                 fks=None, dks=None):
    """The expected ``_reduce_join`` of fact JOIN dim ON fk = dk (numpy):
    (rows, then per output column (valid count, sum)). ``fks``/``dks``:
    what a key column's rows sum to, when not the keys themselves (the
    byte sums of string keys)."""
    nkeys = int(max(fk.max(), dk.max())) + 1
    fks = fk if fks is None else fks
    dks = dk if dks is None else dks
    fok, dok = ~fnull, ~dnull
    dcnt = np.bincount(dk[dok], minlength=nkeys)
    dsum = np.bincount(dk[dok], weights=dv[dok], minlength=nkeys)
    fcnt = np.bincount(fk[fok], minlength=nkeys)
    fkz = np.where(fok, fk, 0)
    if thresh is not None:
        # inner with dv > thresh(fv): per fact row the dim rows of its key
        # above its threshold, off the dim sorted by (key, dv)
        comb = np.sort(dk[dok] * (1 << 20) + dv[dok])
        pre = np.concatenate([[0], np.cumsum(comb & ((1 << 20) - 1))])
        end = np.searchsorted(comb, fkz * (1 << 20) + (1 << 20) - 1, "right")
        beg = np.searchsorted(comb, fkz * (1 << 20) + thresh(fv), "right")
        c = np.where(fok, end - beg, 0)
        s = np.where(fok, pre[end] - pre[beg], 0)
    else:
        c = np.where(fok, dcnt[fkz], 0)
        s = np.where(fok, dsum[fkz], 0)
    pairs = int(c.sum())
    fksz = np.where(fok, fks, 0)
    pair_cols = (pairs, int((fksz * c).sum()), pairs, int((fv * c).sum()),
                 pairs, int((fksz * c).sum()), pairs, int(s.sum()))
    if how == "semi" or how == "anti":
        keep = (c > 0) if how == "semi" else (c == 0)
        return (int(keep.sum()), int((fok & keep).sum()),
                int(fks[fok & keep].sum()), int(keep.sum()),
                int(fv[keep].sum()))
    out = list(pair_cols)
    rows = pairs
    if how in ("left", "full"):
        un = c == 0  # fact rows without a match (null keys included)
        rows += int(un.sum())
        out[0] += int((un & fok).sum())
        out[1] += int(fks[un & fok].sum())
        out[2] += int(un.sum())
        out[3] += int(fv[un].sum())
    if how in ("right", "full"):
        dkz = np.where(dok, dk, 0)
        un = ~dok | (fcnt[dkz] == 0)
        rows += int(un.sum())
        out[4] += int((un & dok).sum())
        out[5] += int(dks[un & dok].sum())
        out[6] += int(un.sum())
        out[7] += int(dv[un].sum())
    return (rows,) + tuple(out)


def bench_join_arrays(np, n: int, dim_rows: int):
    """The bench join's seeded columns (fk, fv, dk, dv) and its numpy
    oracle's rows: (fv, sum(dv), count(*)) sorted by fv."""
    rng = np.random.default_rng(11)
    fk = rng.integers(0, dim_rows, n).astype(np.int64)
    fv = rng.integers(0, 100, n).astype(np.int64)
    dk = np.arange(dim_rows, dtype=np.int64)
    dv = rng.integers(0, 10**6, dim_rows).astype(np.int64)
    s_exp = np.bincount(fv, weights=dv[fk].astype(np.float64), minlength=100)
    c_exp = np.bincount(fv, minlength=100)
    want = sorted((g, int(s_exp[g]), int(c_exp[g])) for g in range(100)
                  if c_exp[g])
    return fk, fv, dk, dv, want


def bench_join(torch, np, dev, n: int, dim_rows: int):
    """The bench join query's inputs (bench.py ``shape_join``: ``n``
    fact rows join ``dim_rows`` dim rows on fk = dk, then group by fv:
    sum(dv), count(*)): the fact and dim batches, the numpy oracle's
    rows and ``plan(conf) -> (join, aggregate)``."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec,
                                             TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col

    fk, fv, dk, dv, want = bench_join_arrays(np, n, dim_rows)
    fs = schema_of(fk=T.LONG, fv=T.LONG)
    ds = schema_of(dk=T.LONG, dv=T.LONG)
    fact = [_padded_batch(np, torch, fs, [fk, fv], [np.ones(n, bool)] * 2,
                          dev)]
    dim = [_padded_batch(np, torch, ds, [dk, dv],
                         [np.ones(dim_rows, bool)] * 2, dev)]

    def plan(conf):
        join = TpuShuffledHashJoinExec(
            conf, InMemoryScanExec(conf, [fact], fs),
            InMemoryScanExec(conf, [dim], ds), [col("fk")], [col("dk")],
            "inner")
        return join, TpuHashAggregateExec(
            conf, [col("fv")],
            [A.agg(A.Sum(col("dv")), "s"), A.agg(A.Count(None), "c")], join)

    return fact, dim, want, plan


def join_query_phase(torch, np, dev, log2_fact: int, dim_rows: int,
                     profile: bool = False):
    """Q6-Q8 through the exec tree, each checked against a numpy oracle,
    with the launch counts set to 0 just before each query and read just
    after it (see the module docstring)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    per_query = {}
    report = []
    # --- Q6/Q7: the bench join query (bench.py shape_join) -----------------
    n = 1 << log2_fact
    fact, dim, want, bench_plan = bench_join(torch, np, dev, n, dim_rows)

    for q, strategy in (("Q6", "PALLAS"), ("Q7", "AUTO")):
        conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
        join, agg = bench_plan(conf)
        reset_launches()
        rows, ms = _run(torch, agg, conf)
        per_query[q] = launches()
        if sorted(rows) != want:
            raise AssertionError(f"{q}: rows differ from the numpy oracle")
        desc = join.describe()
        k4 = per_query[q]["probe_ranges"]
        if per_query[q]["bucket_sum"] <= 0:
            raise AssertionError(f"{q}: the aggregate did not launch K1")
        if q == "Q6" and k4 != len(fact):
            raise AssertionError(f"Q6: {k4} K4 launches for {len(fact)} "
                                 "probe batch(es)")
        if q == "Q7" and (k4 != 0 or "strategy=DIRECT" not in desc
                          or "fused=direct" not in desc):
            raise AssertionError(f"Q7: expected the fused DIRECT path, got "
                                 f"{desc} with {k4} K4 launches")
        report.append({"query": q, "rows": len(rows), "fact_rows": n,
                       "dim_rows": dim_rows, "wall_ms": ms,
                       "join": desc, "agg_strategy":
                       agg._strategy_choice[0], "launches": per_query[q]})
    for line in report:
        emit(line)
    if profile:
        nbytes = n * (8 + 8 + 2) + dim_rows * (8 + 8 + 2)
        for q, strategy in (("Q6", "PALLAS"), ("Q7", "AUTO")):
            conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy":
                               strategy})
            profile_plan(torch, q, lambda c=conf: bench_plan(c)[1], conf, n,
                         nbytes)
    del fact, dim

    # --- Q8: every join type, dup and null keys, PALLAS and AUTO ------------
    fs = schema_of(fk=T.LONG, fv=T.LONG)
    ds = schema_of(dk=T.LONG, dv=T.LONG)
    n8, d8 = 1 << (log2_fact - 3), 1 << (log2_fact - 7)
    r8 = np.random.default_rng(8)
    fk8 = r8.integers(0, 150_000, n8).astype(np.int64)
    fn8 = r8.random(n8) < 0.02
    fv8 = r8.integers(0, 100, n8).astype(np.int64)
    dk8 = r8.integers(0, 100_000, d8).astype(np.int64)
    dn8 = r8.random(d8) < 0.05
    dv8 = r8.integers(0, 10**6, d8).astype(np.int64)
    fact8 = [_padded_batch(np, torch, fs, [np.where(fn8, 0, fk8), fv8],
                           [~fn8, np.ones(n8, bool)], dev)]
    dim8 = [_padded_batch(np, torch, ds, [np.where(dn8, 0, dk8), dv8],
                          [~dn8, np.ones(d8, bool)], dev)]
    q8 = {}
    for how in ("inner_cond", "left", "right", "full", "semi", "anti"):
        for strategy in ("PALLAS", "AUTO"):
            conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy":
                               strategy})
            cond = (E.GreaterThan(col("dv"), E.Multiply(col("fv"),
                                                        lit(10_000)))
                    if how == "inner_cond" else None)
            join = TpuShuffledHashJoinExec(
                conf, InMemoryScanExec(conf, [fact8], fs),
                InMemoryScanExec(conf, [dim8], ds), [col("fk")],
                [col("dk")], "inner" if cond is not None else how, cond)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = _reduce_join(torch, join)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = launches()
            exp = _join_oracle(
                np, fk8, fv8, fn8, dk8, dv8, dn8,
                "inner" if cond is not None else how,
                (lambda v: v * 10_000) if cond is not None else None)
            if got != exp:
                raise AssertionError(f"Q8 {how} {strategy}: {got} != {exp}")
            k4 = counts["probe_ranges"]
            if strategy == "PALLAS" and k4 != 1:
                raise AssertionError(f"Q8 {how} PALLAS: {k4} K4 launches, "
                                     "expected one per probe batch (1)")
            if strategy == "AUTO" and k4 != 0:
                raise AssertionError(f"Q8 {how} AUTO launched K4")
            q8[f"{how}/{strategy}"] = {"rows": got[0], "wall_ms": ms,
                                       "join": join.describe()}
            per_query.setdefault("Q8", dict.fromkeys(counts, 0))
            for k, v in counts.items():
                per_query["Q8"][k] += v
    emit({"query": "Q8", "fact_rows": n8, "dim_rows": d8, "runs": q8,
          "launches": per_query["Q8"]})
    return per_query


# ---------------------------------------------------------------------------
# string data (Q9, Q10)
# ---------------------------------------------------------------------------
#: the bench's string pool (bench.py ``shape_string``): 14 entries x 4
STRING_POOL = [
    "alpha-001", "beta-smallX", "gamma", "delta-verylongvalue-0042",
    "epsilon-X", "zeta", "eta-middling", "theta-X-suffix", "iota",
    "kappa-longish-string", "", "lambda-Xx", "mu-0", "nu-tail",
] * 4
#: the six ASCII whitespace bytes the word count splits on
WHITESPACE = (0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D)


def string_pool_rows(np, n: int):
    """Q9's data, as bench.py draws it with ``rng(17)``: pool indices and
    v in [0, 1000); plus the expanded Arrow planes of ``s`` (offsets
    (n+1,), chars)."""
    rng = np.random.default_rng(17)
    idx = rng.integers(0, len(STRING_POOL), n)
    v = rng.integers(0, 1000, n).astype(np.int64)
    enc = [e.encode("utf-8") for e in STRING_POOL]
    plens = np.array([len(b) for b in enc], np.int64)
    pstart = np.concatenate([[0], np.cumsum(plens)[:-1]])
    pool = np.frombuffer(b"".join(enc), np.uint8)
    lens = plens[idx]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    src = (np.repeat(pstart[idx] - offsets[:-1], lens)
           + np.arange(offsets[-1]))
    return idx, v, offsets, pool[src]


def pool_dict_column(np, dev, pool, idx):
    """The bench's dictionary layout of rows ``idx`` over ``pool``
    (``bench.py:_dev_string_col``): the pool's distinct values, sorted
    bytewise, as the dictionary, int32 codes, ``unique`` set, ``max_len``
    the longest entry and ``mat_cap`` the rows' bytes bucketed."""
    from spark_rapids_tpu_torch.columnar import (choose_capacity,
                                                 dict_column_from_parts)

    n = idx.size
    cap = choose_capacity(n)
    uniq, inv = np.unique(np.array([e.encode("utf-8") for e in pool],
                                   dtype=object), return_inverse=True)
    codes = np.zeros(cap, np.int32)
    codes[:n] = inv[idx]
    lens = np.array([len(b) for b in uniq], np.int64)
    doff = np.zeros(len(uniq) + 1, np.int32)
    np.cumsum(lens, out=doff[1:])
    flat = b"".join(uniq)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return dict_column_from_parts(
        n, codes, doff, np.frombuffer(flat or b"\0", np.uint8), valid,
        mat_cap=choose_capacity(max(1, int(lens[codes[:n]].sum())), 128),
        max_len=int(lens.max()), unique=True, device=dev)


def word_count_text(np, rng, n: int):
    """Q10's text column: each row has 0-16 words of 1-12 bytes of
    [a-z] (about 5% of words carry one 2-byte UTF-8 letter, U+00E0 to
    U+00FF), separated by runs of 1-3 bytes drawn from the six ASCII
    whitespace bytes; an eighth of the rows start with such a run and an
    eighth end with one; 2% of rows are null (and hold no bytes). Returns
    (offsets (n+1,) int64, chars uint8, valid (n,) bool, words (n,)): the
    Arrow planes and each row's word count."""
    valid = rng.random(n) >= 0.02
    words = np.where(valid, rng.integers(0, 17, n), 0)
    lead = valid & (rng.random(n) < 0.125)
    trail = valid & (rng.random(n) < 0.125)
    nseg = lead + np.maximum(2 * words - 1, 0) + trail
    seg_row = np.repeat(np.arange(n), nseg)
    first = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    j = np.arange(seg_row.size) - first[seg_row] - lead[seg_row]
    is_word = (j >= 0) & (j < 2 * words[seg_row] - 1) & (j % 2 == 0)
    nw = int(is_word.sum())
    wlen = rng.integers(1, 13, nw)
    utf8 = rng.random(nw) < 0.05
    wlen = np.where(utf8, np.maximum(wlen, 2), wlen)
    seglen = rng.integers(1, 4, seg_row.size)
    seglen[is_word] = wlen
    chars = rng.choice(np.array(WHITESPACE, np.uint8), int(seglen.sum()))
    seg_start = np.concatenate([[0], np.cumsum(seglen)[:-1]])
    word_byte = np.repeat(is_word, seglen)
    chars[word_byte] = rng.integers(ord("a"), ord("z") + 1,
                                    int(word_byte.sum()))
    at = seg_start[is_word][utf8] + (rng.random(int(utf8.sum()))
                                     * (wlen[utf8] - 1)).astype(np.int64)
    chars[at] = 0xC3
    chars[at + 1] = 0xA0 + rng.integers(0, 32, at.size)
    row_bytes = np.bincount(seg_row, weights=seglen, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(row_bytes.astype(np.int64), out=offsets[1:])
    return offsets, chars.astype(np.uint8), valid, words


def _word_count_batches(np, dev, log2_rows: int):
    """Q10's batches (seeded): per batch k int32 in [0, 64) and the text
    column, uploaded as the engine's own batches are (pool padded to its
    capacity bucket); plus k, the word counts and validity on the host."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import (ColumnarBatch, DeviceColumn,
                                                 HostColumn, schema_of)

    rng = np.random.default_rng(10)
    per = (1 << log2_rows) // WORD_COUNT_BATCHES
    schema = schema_of(k=T.INT, s=T.STRING)
    batches, ks, words, valids = [], [], [], []
    for _ in range(WORD_COUNT_BATCHES):
        k = rng.integers(0, 64, per).astype(np.int32)
        off, chars, valid, w = word_count_text(np, rng, per)
        scol = DeviceColumn.from_string_arrays(T.STRING, per, off, chars,
                                               valid, dev)
        kcol = DeviceColumn.from_host(HostColumn(T.INT, k,
                                                 np.ones(per, bool)),
                                      per, "k", dev)
        batches.append(ColumnarBatch([kcol, scol], schema, per))
        ks.append(k)
        words.append(w)
        valids.append(valid)
    return (batches, schema, np.concatenate(ks), np.concatenate(words),
            np.concatenate(valids))


def udf_kernel_phase(torch, np, dev, batch, words, reps: int):
    """K5 on one Q10 batch as the query hands it over: equal to its plain
    version and to the generator's word counts (``words``) on every row,
    and so on a slice of rows whose offsets start mid-pool with non-space
    garbage past its last offset; timed beside its plain version and its
    bytes bound. The bound counts what the word count needs: the live
    chars read once, 4 bytes of offsets and 4 of output per row;
    ``bound_abi_ms`` counts what the launch moves as called (the 16-byte
    chunks holding the live chars, every offset, the output). No single
    torch call computes word counts, so there is no library time."""
    from spark_rapids_tpu_torch.ops import udf_kernels as UK

    scol = batch.columns[1]
    offsets, chars = scol.offsets, scol.chars
    rows = offsets.shape[0] - 1
    start, live = int(offsets[0]), int(offsets[-1])
    want = torch.from_numpy(np.asarray(words, np.int32)).to(dev)
    got = UK.word_counts(offsets, chars)
    if not torch.equal(got, UK.word_counts_plain(offsets, chars)):
        raise AssertionError("word_counts: kernel != plain")
    if not torch.equal(got[:want.shape[0]], want) or bool(
            got[want.shape[0]:].any()):
        raise AssertionError("word_counts: differs from the generator's "
                             "word counts")
    # rows [a, b): offsets start mid-pool; bytes past offsets[b] are
    # non-space garbage that must not count
    a, b = rows // 3 + 1, 2 * rows // 3
    sub = offsets[a:b + 1]
    garbage = chars.clone()
    garbage[int(sub[-1]):] = ord("a")
    got = UK.word_counts(sub, garbage)
    if not (torch.equal(got, want[a:b])
            and torch.equal(got, UK.word_counts_plain(sub, garbage))):
        raise AssertionError("word_counts: wrong on a mid-pool slice")
    del garbage
    chunks = -(-live // 16) - start // 16
    res = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: UK.word_counts(offsets, chars), reps),
        "dev_ms": dev_ms(torch, lambda: UK.word_counts(offsets, chars),
                         reps),
        "host_ms": host_ms(torch, lambda: UK.word_counts(offsets, chars),
                           reps),
        "plain_ms": cuda_ms(torch, lambda: UK.word_counts_plain(
            offsets, chars), reps),
        "library_ms": None,
        "library": "none: no single torch call",
        "bound_ms": bound_ms(int(UK.word_counts_bytes(offsets))),
        "bound_abi_ms": bound_ms(16 * chunks + 4 * (rows + 1) + 4 * rows),
    }
    emit({"kernel_shape": "word_counts", "rows": rows,
          "pool_bytes": int(chars.shape[0]), "live_bytes": live - start,
          **res})
    return res


def string_query_phase(torch, np, dev, log2_rows: int, wc_batches,
                       profile: bool = False):
    """Q9 and Q10 through the exec tree, each checked against an exact
    oracle, with the launch counts set to 0 just before each query and
    read just after it."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import (ColumnarBatch, DeviceColumn,
                                                 HostColumn, schema_of)
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.udf import string_word_count

    per_query = {}
    conf = RapidsConf({})
    # --- Q9: the bench string query, in the bench's layout (Q9) and
    # expanded (Q9x) ----------------------------------------------------
    n = 1 << log2_rows
    idx, v, offsets, chars = string_pool_rows(np, n)
    schema9 = schema_of(s=T.STRING, v=T.LONG)
    vcol = DeviceColumn.from_host(HostColumn(T.LONG, v, np.ones(n, bool)),
                                  n, "v", dev)
    layouts = {
        "Q9": pool_dict_column(np, dev, STRING_POOL, idx),
        "Q9x": DeviceColumn.from_string_arrays(T.STRING, n, offsets, chars,
                                               np.ones(n, bool), dev)}
    counts = np.bincount(idx, minlength=len(STRING_POOL))
    hit = np.array(["X" in e for e in STRING_POOL])
    want = [(sum(min(6, len(e)) * int(c) for e, c, h in
                 zip(STRING_POOL, counts, hit) if h),
             sum(len(e) * int(c) for e, c, h in
                 zip(STRING_POOL, counts, hit) if h),
             int(counts[hit].sum()), int(v[hit[idx]].sum()))]
    for q, scol in layouts.items():
        batch9 = ColumnarBatch([scol, vcol], schema9, n)

        def q9_plan(batch9=batch9):
            scan = InMemoryScanExec(conf, [[batch9]], schema9)
            filt = TpuFilterExec(conf, E.Contains(col("s"), lit("X")), scan)
            proj = TpuProjectExec(conf, [
                E.Alias(E.Substring(E.Upper(col("s")), lit(1), lit(6)),
                        "u"),
                E.Alias(E.Length(col("s")), "ln"), col("v")], filt)
            return TpuHashAggregateExec(conf, [], [
                A.agg(A.Sum(E.Length(col("u"))), "ul"),
                A.agg(A.Sum(col("ln")), "l"), A.agg(A.Count(None), "c"),
                A.agg(A.Sum(col("v")), "sv")], proj)

        def check(rows, q=q):
            if rows != want:
                raise AssertionError(f"{q}: {rows} != {want}")

        cold, warm, per_query[q] = _walls(
            torch, q, lambda: _run(torch, q9_plan(), conf)[0], check)
        if any(per_query[q].values()):
            raise AssertionError(f"{q} launched {per_query[q]}")
        if scol.is_dict:
            d = scol.dictv
            # codes and validity per row, the 14-entry dictionary once
            in_bytes = (5 * n + 4 * (d.dict_size + 1)
                        + int(d.dictionary.offsets[-1]) + 9 * n)
            layout = {"layout": "dictionary", "dict_size": d.dict_size,
                      "dict_bytes": int(d.dictionary.offsets[-1])}
        else:
            # each input plane read once: offsets, live chars, validity,
            # and the fixed-width column with its validity
            in_bytes = 4 * (n + 1) + int(offsets[-1]) + n + 9 * n
            layout = {"layout": "expanded"}
        emit({"query": q, "rows": n, "result": want[0], **layout,
              "cold_wall_ms": cold, "warm_wall_ms": warm,
              "char_bytes": int(offsets[-1]), "bytes": in_bytes,
              "bound_ms": bound_ms(in_bytes), "launches": per_query[q]})
        # the two layouts' device busy time side by side, in every run
        profile_plan(torch, q, q9_plan, conf, n, in_bytes)

    # --- Q10: the native-UDF word count -----------------------------------
    batches, schema10, k, words, valid = wc_batches

    def q10_plan():
        scan = InMemoryScanExec(conf, [batches], schema10)
        proj = TpuProjectExec(conf, [col("k"), E.Alias(
            string_word_count(col("s")), "wc")], scan)
        return TpuHashAggregateExec(conf, [col("k")], [
            A.agg(A.Sum(col("wc")), "sw"), A.agg(A.Count(col("wc")), "cw"),
            A.agg(A.Count(None), "c")], proj)

    reset_launches()
    agg = q10_plan()
    rows, ms10 = _run(torch, agg, conf)
    per_query["Q10"] = launches()
    sw = np.bincount(k, weights=np.where(valid, words, 0), minlength=64)
    cw = np.bincount(k[valid], minlength=64)
    c = np.bincount(k, minlength=64)
    want = [(g, int(sw[g]), int(cw[g]), int(c[g])) for g in range(64)
            if c[g]]
    if sorted(rows) != want:
        raise AssertionError("Q10: rows differ from the generator's counts")
    k5 = per_query["Q10"]["word_counts"]
    if k5 != len(batches) or per_query["Q10"]["bucket_sum"] <= 0:
        raise AssertionError(f"Q10: {k5} K5 launches for {len(batches)} "
                             f"batches, K1 {per_query['Q10']['bucket_sum']}")
    live = sum(int(b.columns[1].offsets[-1]) for b in batches)
    pool = sum(int(b.columns[1].chars.shape[0]) for b in batches)
    emit({"query": "Q10", "rows": int(k.size), "batches": len(batches),
          "groups": len(rows), "wall_ms": ms10, "char_bytes": live,
          "pool_bytes": pool, "agg_strategy": agg._strategy_choice[0],
          "launches": per_query["Q10"]})
    if profile:
        nrows = int(k.size)
        profile_plan(torch, "Q10", q10_plan, conf, nrows,
                     4 * (nrows + len(batches)) + live + nrows + 5 * nrows)
    return per_query


# ---------------------------------------------------------------------------
# sort and window phase (Q13, Q14): the bench's last two shapes
# ---------------------------------------------------------------------------
#: Q13's and Q14's rows (bench.py ``shape_sort`` and ``shape_window`` at
#: scale 1), as a power of two
SORT_LOG2_ROWS = 23
#: substrings of the device kernels a sort launches (CUB's radix sort
#: passes; torch's in-place sort of short rows), for the sort's share of
#: a profile
SORT_KERNELS = ("RadixSort", "sortKeyValue", "radix_sort")


def _walls(torch, what, run_once, check, runs: int = 4):
    """The cold wall (first run) and ``runs - 1`` warm walls of
    ``run_once()`` (which returns rows), each result checked, and the
    first run's launch counts: they are set to 0 just before each run
    and read just after it, and every run must repeat the first one's
    (the aggregates' routes too)."""
    walls = []
    counts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rows = run_once()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts.append(launches())
        check(rows)
    if any(c != counts[0] or c.agg_route != counts[0].agg_route
           for c in counts[1:]):
        raise AssertionError(f"{what} launches or routes changed between "
                             f"runs: {[(c, c.agg_route) for c in counts]}")
    return walls[0], walls[1:], counts[0]


def sort_window_phase(torch, np, dev, log2_rows: int,
                      profile: bool = False):
    """Q13 (the bench's ORDER BY ... LIMIT 1000) and Q14 (its window query)
    through the exec tree, each against an exact numpy oracle, with the
    launch counts set to 0 just before each run and read just after it;
    Q14's window output is also held to numpy whole, before its filter.
    Neither launches a hand kernel: the sort is ``torch.argsort`` passes
    and the window's scans are torch ops."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import InMemoryScanExec, TpuFilterExec
    from spark_rapids_tpu_torch.exec.basic import TpuLocalLimitExec
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    from spark_rapids_tpu_torch.exec.window import TpuWindowExec
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr import windows as W
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    conf = RapidsConf({})
    n = 1 << log2_rows
    per_query = {}

    # --- Q13: bench.py shape_sort ------------------------------------------
    rng = np.random.default_rng(7)
    key = rng.integers(-(2**40), 2**40, n)
    pay = rng.integers(0, 1000, n).astype(np.int32)
    schema = schema_of(key=T.LONG, pay=T.INT)
    batch = _padded_batch(np, torch, schema, [key, pay],
                          [np.ones(n, bool)] * 2, dev)
    top = np.argsort(key, kind="stable")[:1000]
    want13 = list(zip(key[top].tolist(), pay[top].tolist()))

    def q13_plan():
        srt = TpuSortExec(conf, [col("key")], [(True, True)],
                          InMemoryScanExec(conf, [[batch]], schema))
        return TpuLocalLimitExec(conf, 1000, srt)

    def check13(rows):
        if rows != want13:
            raise AssertionError("Q13: rows differ from numpy's stable "
                                 "argsort")

    cold, warm, per_query["Q13"] = _walls(
        torch, "Q13", lambda: _run(torch, q13_plan(), conf)[0], check13)
    emit({"query": "Q13", "rows": n, "limit": 1000, "cold_wall_ms": cold,
          "warm_wall_ms": warm, "bytes": n * 14,
          "bound_ms": bound_ms(n * 14), "launches": per_query["Q13"]})
    if profile:
        profile_plan(torch, "Q13", q13_plan, conf, n, n * 14, SORT_KERNELS)

    # --- Q14: bench.py shape_window ----------------------------------------
    rng = np.random.default_rng(13)
    k = rng.integers(0, 64, n).astype(np.int32)
    ts = rng.permutation(n).astype(np.int64)
    v = rng.integers(0, 1000, n).astype(np.int64)
    schema = schema_of(k=T.INT, ts=T.LONG, v=T.LONG)
    batch = _padded_batch(np, torch, schema, [k, ts, v],
                          [np.ones(n, bool)] * 3, dev)
    order = np.lexsort((ts, k))
    want14 = []
    for g in range(64):
        rows = order[k[order] == g][:3]
        rs = np.cumsum(v[rows])
        want14 += [(g, int(ts[r]), int(v[r]), int(s_), i + 1)
                   for i, (r, s_) in enumerate(zip(rows, rs))]

    def q14_plan():
        spec = W.WindowSpec(partition_by=(col("k"),), order_by=(col("ts"),),
                            orders=((True, True),))
        win = TpuWindowExec(conf, [
            W.WindowExpression(A.Sum(col("v")), spec, "rs"),
            W.WindowExpression(W.RowNumber(), spec, "rn")],
            InMemoryScanExec(conf, [[batch]], schema))
        return TpuFilterExec(conf, E.LessThanOrEqual(col("rn"), lit(3)),
                             win)

    def check14(rows):
        if rows != want14:
            raise AssertionError("Q14: rows differ from the numpy oracle")

    def check14_full(win):
        """The window's whole output (the filter keeps 192 of its rows),
        column by column against numpy: rows in (k, ts) order, rn the
        position in the partition, rs the partition's running sum."""
        hosts = [b.host_columns() for p in range(win.num_partitions)
                 for b in win.execute_partition(p)]
        got = [np.concatenate([h[i].data for h in hosts]) for i in range(5)]
        if not all(np.concatenate([h[i].validity for h in hosts]).all()
                   for i in range(5)):
            raise AssertionError("Q14 window: a null in the output")
        ks, vs = k[order], v[order]
        idx = np.arange(n)
        start = np.maximum.accumulate(
            np.where(np.r_[True, ks[1:] != ks[:-1]], idx, 0))
        cs = np.cumsum(vs)
        want = [ks, ts[order], vs, cs - cs[start] + vs[start],
                idx - start + 1]
        for name, g, w in zip(("k", "ts", "v", "rs", "rn"), got, want):
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"Q14 window: column {name} differs "
                                     "from the numpy oracle")

    cold, warm, per_query["Q14"] = _walls(
        torch, "Q14", lambda: _run(torch, q14_plan(), conf)[0], check14)
    check14_full(q14_plan().children[0])
    emit({"query": "Q14", "rows": n, "out_rows": len(want14),
          "cold_wall_ms": cold, "warm_wall_ms": warm, "bytes": n * 23,
          "bound_ms": bound_ms(n * 23), "launches": per_query["Q14"]})
    if profile:
        profile_plan(torch, "Q14", q14_plan, conf, n, n * 23, SORT_KERNELS)
    return per_query


# ---------------------------------------------------------------------------
# session phase (Q11, Q12): the session's own entry points
# ---------------------------------------------------------------------------
#: the tagging report Q12 must give above its plan analysis block (the
#: reference's, pinned by tests/test_torch_session.py against the JAX
#: package on the CPU)
Q12_EXPLAIN = (
    "*Exec <HashAggregateExec> will run on TPU\n"
    "  !Exec <ProjectExec> cannot run on TPU because expression PythonUDF "
    "is not supported on TPU\n"
    "    *Exec <ScanExec> will run on TPU")
#: where Q11 writes its parquet file (git-ignored; removed after the run)
PARQUET_DIR = "_chip_data"
#: Q11's rows (bench.py ``shape_parquet`` at scale 1) and Q12's, as powers
#: of two
PARQUET_LOG2_ROWS = 23
UDF_LOG2_ROWS = 16


def bench_parquet_table(np, n: int):
    """The bench's store_sales-like columns (``bench.py:549-559``, seed
    19), as numpy arrays in the bench's draw order."""
    rng = np.random.default_rng(19)
    prices = np.round(rng.uniform(1.0, 100.0, 9750), 2)
    item = rng.integers(1, 18_001, n).astype(np.int32)
    qty = rng.integers(1, 101, n).astype(np.int32)
    cost = prices[rng.integers(0, 9750, n)]
    date = (2_450_815 + rng.integers(0, 2400, n)).astype(np.int32)
    return item, qty, cost, date


def q11_check(np, qty, cost, date):
    """``check(rows, what)`` of Q11's rows against numpy: per
    ss_quantity of the rows sold on or after day 2452015, the count
    exactly and the sum within 1e-9 of the group's sum of |x|."""
    keep = date >= 2_452_015
    want_c = np.bincount(qty[keep], minlength=101)
    want_s = np.bincount(qty[keep], weights=cost[keep], minlength=101)
    want_abs = np.bincount(qty[keep], weights=np.abs(cost[keep]),
                           minlength=101)

    def check(rows, what):
        if len(rows) != int((want_c > 0).sum()):
            raise AssertionError(f"{what}: {len(rows)} groups")
        for g, s_, c_ in rows:
            if c_ != int(want_c[g]) or not _close(s_, want_s[g],
                                                  want_abs[g]):
                raise AssertionError(f"{what} group {g}: ({s_}, {c_}) != "
                                     f"({want_s[g]}, {want_c[g]})")
    return check


def udf_times_three_plus_one(v) -> int:
    """Q12's Python UDF (annotated ``-> int``: a LONG result)."""
    return None if v is None else v * 3 + 1


def _device_tree(node):
    """Every exec of a device subtree (the children of each)."""
    yield node
    for c in getattr(node, "children", []):
        yield from _device_tree(c)


def session_query_phase(torch, np, dev, log2_parquet: int, log2_udf: int,
                        profile: bool = False):
    """Q11 (the bench parquet query) and Q12 (the PythonUDF fallback
    boundary) through ``TpuSession``, each checked against a numpy oracle,
    with the launch counts set to 0 just before each query and read just
    after it."""
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.cpu import plan as C
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             RowToColumnarExec,
                                             TpuFilterExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.exec.transitions import ColumnarToRowExec
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql import session as S

    per_query = {}

    def timed_collect(df):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = df.collect()
        torch.cuda.synchronize()
        return rows, (time.perf_counter() - t0) * 1e3

    # --- Q11: the bench parquet query -------------------------------------
    n = 1 << log2_parquet
    item, qty, cost, date = bench_parquet_table(np, n)
    here = os.path.dirname(os.path.abspath(__file__))
    pdir = os.path.join(here, PARQUET_DIR, "store_sales")
    shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)
    os.makedirs(pdir)
    try:
        t0 = time.perf_counter()
        pq.write_table(pa.table({
            "ss_item_sk": item, "ss_quantity": qty,
            "ss_wholesale_cost": cost, "ss_sold_date_sk": date}),
            os.path.join(pdir, "t.parquet"), row_group_size=1 << 21)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(os.path.join(pdir, "t.parquet"))
        sess = S.TpuSession(
            {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True},
            device=dev)

        def q11():
            return (sess.read.parquet(pdir)
                    .where(E.GreaterThanOrEqual(col("ss_sold_date_sk"),
                                                lit(2_452_015)))
                    .group_by("ss_quantity")
                    .agg(A.agg(A.Sum(col("ss_wholesale_cost")), "s"),
                         A.agg(A.Count(col("ss_item_sk")), "c")))

        check = q11_check(np, qty, cost, date)

        # cold: a fresh process-level scan cache and scanner cache
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        reset_launches()
        routes = decode_routes()
        rows, cold_ms = timed_collect(q11())
        per_query["Q11"] = launches()
        routes = query_routes("Q11", routes)
        check(rows, "Q11 cold")
        top = sess.last_executed_plan
        agg = top.tpu_child if isinstance(top, ColumnarToRowExec) else None
        if not (isinstance(agg, TpuHashAggregateExec)
                and isinstance(agg.children[0], TpuFilterExec)
                and isinstance(agg.children[0].children[0],
                               TpuFileSourceScanExec)):
            raise AssertionError(f"Q11 plan: {top.tree_string()}")
        if any(isinstance(e, RowToColumnarExec) for e in _device_tree(agg)):
            raise AssertionError("Q11 plan holds a CPU exec")
        for name in ("bucket_sum", "bucket_float_sum"):
            if per_query["Q11"][name] <= 0:
                raise AssertionError(f"Q11 did not launch {name}")
        scan = agg.children[0].children[0]
        m = {k: v.value for k, v in scan.metrics.items()}
        decoded = n * (4 + 4 + 8 + 4)
        # every column chunk decoded on the card: none through pyarrow's
        # host decode, no split through the plain reader, and less
        # uploaded than the decoded columns hold
        if m["hostFallbackChunks"] or m["scanTime"] or not (
                0 < m["uploadBytes"] < decoded):
            raise AssertionError(
                f"Q11 left the device-decode route: {m['hostFallbackChunks']}"
                f" chunks on the host, read {m['scanTime']} ns, uploaded "
                f"{m['uploadBytes']} of {decoded} bytes")
        route = per_query["Q11"].agg_route
        if dev.type == "cuda" and route != {"stage": 1}:
            raise AssertionError(f"Q11 under AUTO took {route}, not the "
                                 "fused stage")
        warm = []
        for _ in range(3):
            rows, ms = timed_collect(q11())
            check(rows, "Q11 warm")
            warm.append(ms)
        cache = DeviceScanCache.get_instance(sess.conf).stats()
        emit({"query": "Q11", "pyarrow": pa.__version__, "rows": n,
              "row_groups": n >> 21 or 1,
              "groups": len(rows), "file_bytes": file_bytes,
              "write_s": write_s, "cold_wall_ms": cold_ms,
              "warm_wall_ms": warm,
              "scan_decode_ms": m["tpuDecodeTime"] / 1e6,
              "host_decode_ms": m["hostDecodeTime"] / 1e6,
              "scan_read_ms": m["scanTime"] / 1e6,
              "upload_bytes": m["uploadBytes"],
              "host_fallback_chunks": m["hostFallbackChunks"],
              "decode_routes": routes,
              "decoded_bytes": decoded, "bound_ms": bound_ms(decoded),
              "scan_cache": cache,
              "agg_strategy": agg._strategy_choice[0],
              "launches": per_query["Q11"]})
        # Q11o: stageFusion OFF (the scan's decoded batches, then the
        # fused plan); Q11u: both fusions OFF (the streaming route)
        for q, extra, want_route in (
                ("Q11o", {"spark.rapids.tpu.sql.stageFusion": "OFF"},
                 {"plan": 1}),
                ("Q11u", FUSION_OFF, {"update": 1})):
            sess_o = S.TpuSession(
                {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
                 **extra}, device=dev)

            def q11o(sess_o=sess_o):
                return (sess_o.read.parquet(pdir)
                        .where(E.GreaterThanOrEqual(col("ss_sold_date_sk"),
                                                    lit(2_452_015)))
                        .group_by("ss_quantity")
                        .agg(A.agg(A.Sum(col("ss_wholesale_cost")), "s"),
                             A.agg(A.Count(col("ss_item_sk")), "c")))

            DeviceScanCache.reset()
            S._SCANNER_CACHE.clear()
            cold_o, warm_o, per_query[q] = _walls(
                torch, q, lambda: timed_collect(q11o())[0],
                lambda rows, q=q: check(rows, q))
            route = per_query[q].agg_route
            if dev.type == "cuda" and route != want_route:
                raise AssertionError(f"{q} took {route}, not {want_route}")
            if per_query[q] != per_query["Q11"]:
                raise AssertionError(f"{q} launches {dict(per_query[q])} "
                                     f"!= Q11's {dict(per_query['Q11'])}")
            emit({"query": q, "settings": extra, "cold_wall_ms": cold_o,
                  "warm_wall_ms": warm_o,
                  "scan_cache": DeviceScanCache.get_instance(
                      sess_o.conf).stats(),
                  "launches": per_query[q]})
        emit({"host_decode": "Q11", **host_decode_timing(
            np, os.path.join(pdir, "t.parquet"), DECODE_SWEEP)})
        # Q11's cold wall by the size of the scan's host-decode pool
        cold_by_threads = {}
        for th in DECODE_SWEEP * 2:
            with decode_pool_size(th):
                DeviceScanCache.reset()
                S._SCANNER_CACHE.clear()
                rows, ms = timed_collect(q11())
                check(rows, f"Q11 cold, {th} decode threads")
            cold_by_threads[th] = min(ms, cold_by_threads.get(th, ms))
        emit({"query": "Q11", "cold_wall_ms_by_decode_threads":
              cold_by_threads})
        if profile:
            profile_plan(torch, "Q11", lambda: sess._execute(
                q11().node).tpu_child, sess.conf, n, decoded)
        per_query["Q15"] = q15_top_n(torch, np, sess, pdir, item, qty, cost,
                                     date, profile)
    finally:
        shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)

    # --- Q12: the PythonUDF fallback boundary ------------------------------
    m_rows = 1 << log2_udf
    rng = np.random.default_rng(12)
    k = rng.integers(0, 50, m_rows).astype(np.int32)
    x = rng.integers(-10**6, 10**6, m_rows).astype(np.int64)
    xnull = rng.random(m_rows) < 0.05
    schema = T.StructType((T.StructField("k", T.INT),
                           T.StructField("x", T.LONG)))
    sess12 = S.TpuSession({}, device=dev)

    def q12():
        df = sess12.create_dataframe(
            {"k": k.tolist(),
             "x": [None if z else int(v) for v, z in zip(x, xnull)]},
            schema)
        udf = E.PythonUDF(udf_times_three_plus_one, (col("x"),))
        return (df.select(col("k"), E.Alias(udf, "u"))
                .group_by("k").agg(A.agg(A.Sum(col("u")), "su"),
                                   A.agg(A.Count(col("u")), "cu")))

    text = q12().explain()
    tagging, sep, _ = text.partition("\n== Static Plan Analysis ==\n")
    if tagging != Q12_EXPLAIN or not sep:
        raise AssertionError(f"Q12 explain:\n{text}")
    reset_launches()
    rows, ms12 = timed_collect(q12())
    per_query["Q12"] = launches()
    u = np.where(xnull, 0, x * 3 + 1)
    want_cu = np.bincount(k[~xnull], minlength=50)
    want = sorted((g, int(u[k == g].sum()), int(want_cu[g]))
                  for g in range(50) if (k == g).any())
    if sorted(rows) != want:
        raise AssertionError("Q12: rows differ from the oracle")
    top = sess12.last_executed_plan
    agg = top.tpu_child
    r2c = agg.children[0]
    proj = getattr(r2c, "cpu_child", None)
    c2r = proj.children[0] if proj is not None else None
    if not (isinstance(agg, TpuHashAggregateExec)
            and isinstance(r2c, RowToColumnarExec)
            and isinstance(proj, C.CpuProjectExec)
            and isinstance(c2r, ColumnarToRowExec)
            and isinstance(c2r.tpu_child, InMemoryScanExec)):
        raise AssertionError(f"Q12 plan: {top.tree_string()}")
    if per_query["Q12"]["bucket_sum"] <= 0:
        raise AssertionError("Q12 did not launch bucket_sum")
    emit({"query": "Q12", "rows": m_rows, "groups": len(rows),
          "wall_ms": ms12, "explain": text.splitlines(),
          "agg_strategy": agg._strategy_choice[0],
          "launches": per_query["Q12"]})
    per_query["Q16"] = q16_compiled_udfs(torch, np, dev, k, x, xnull, schema,
                                         want, profile)
    per_query["small"] = small_session_phase(torch, dev)
    return per_query


#: Q15's date cut (Q11's) and row limit
Q15_DATE = 2_452_015
Q15_LIMIT = 100
#: Q15's launches at Q11's full size (PARQUET_LOG2_ROWS): the aggregate's
#: three hash tiers at 18 000 groups, then the sort fallback on the RADIX
#: kernel, in each of four partials and the merge
Q15_LAUNCHES = {"bucket_sum": 15, "bucket_float_sum": 15,
                "bucket_winner": 15, "ordered_segment_sum": 0,
                "probe_ranges": 0, "word_counts": 0,
                "dfa_accept_rows": 0, "radix_segment_reduce": 5}


def q15_top_n(torch, np, sess, pdir, item, qty, cost, date,
              profile: bool = False) -> dict:
    """Q15, a TPC-DS-shaped top-N over Q11's file through the same
    session: where ss_sold_date_sk >= 2452015 -> group by ss_item_sk:
    count(ss_quantity) n, sum(ss_wholesale_cost) s -> order by n DESC,
    ss_item_sk -> limit 100. Keys and counts exact, sums within 1e-9 of
    each group's sum of |x|; the plan must be collect limit <- sort <-
    aggregate <- filter <- file scan, all on the device; every run must
    launch K1 and K2 and repeat the first run's counts, which at Q11's
    full size must be ``Q15_LAUNCHES``. Returns the first run's counts."""
    from spark_rapids_tpu_torch.exec import (RowToColumnarExec,
                                             TpuFilterExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.exec.basic import TpuCollectLimitExec
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    def q15():
        return (sess.read.parquet(pdir)
                .where(E.GreaterThanOrEqual(col("ss_sold_date_sk"),
                                            lit(Q15_DATE)))
                .group_by("ss_item_sk")
                .agg(A.agg(A.Count(col("ss_quantity")), "n"),
                     A.agg(A.Sum(col("ss_wholesale_cost")), "s"))
                .order_by("n", "ss_item_sk", ascending=[False, True])
                .limit(Q15_LIMIT))

    keep = date >= Q15_DATE
    cnt = np.bincount(item[keep], minlength=18_001)
    tot = np.bincount(item[keep], weights=cost[keep], minlength=18_001)
    mag = np.bincount(item[keep], weights=np.abs(cost[keep]),
                      minlength=18_001)
    ids = np.nonzero(cnt)[0]
    top = ids[np.lexsort((ids, -cnt[ids]))][:Q15_LIMIT]

    def check(rows):
        if [(r[0], r[1]) for r in rows] != [(int(g), int(cnt[g]))
                                            for g in top]:
            raise AssertionError("Q15: keys or counts differ from numpy")
        for (g, _, s_), w in zip(rows, top):
            if not _close(s_, tot[w], mag[w]):
                raise AssertionError(f"Q15 item {g}: sum {s_} != {tot[w]}")

    first, warm, counts = _walls(torch, "Q15", lambda: q15().collect(),
                                 check)
    for name in ("bucket_sum", "bucket_float_sum"):
        if counts[name] <= 0:
            raise AssertionError(f"Q15 did not launch {name}")
    if item.shape[0] == 1 << PARQUET_LOG2_ROWS and counts != Q15_LAUNCHES:
        raise AssertionError(f"Q15 launches {counts} != {Q15_LAUNCHES}")
    top_exec = sess.last_executed_plan.tpu_child
    chain = [top_exec]
    while chain[-1].children:
        chain.append(chain[-1].children[0])
    kinds = (TpuCollectLimitExec, TpuSortExec, TpuHashAggregateExec,
             TpuFilterExec, TpuFileSourceScanExec)
    if len(chain) != len(kinds) or not all(
            isinstance(e, t) for e, t in zip(chain, kinds)):
        raise AssertionError(f"Q15 plan: {top_exec.tree_string()}")
    if any(isinstance(e, RowToColumnarExec) for e in chain):
        raise AssertionError("Q15 plan holds a CPU exec")
    emit({"query": "Q15", "groups": int(len(ids)), "limit": Q15_LIMIT,
          "first_wall_ms": first, "warm_wall_ms": warm,
          "agg_strategy": chain[2]._strategy_choice[0],
          "plan": top_exec.tree_string().splitlines(),
          "launches": counts})
    if profile:
        profile_plan(torch, "Q15", lambda: sess._execute(
            q15().node).tpu_child, sess.conf, int(keep.sum()),
            item.shape[0] * 20, SORT_KERNELS)
    return counts


def udf_branch(v) -> int:
    """Q16's second UDF: a branch, compiled to an ``If``."""
    return None if v is None else (v * 3 + 1 if v > 100 else -v)


def q16_compiled_udfs(torch, np, dev, k, x, xnull, schema, q12_rows,
                      profile: bool = False) -> dict:
    """Q16: Q12's data and query with
    ``spark.rapids.tpu.sql.udfCompiler.enabled``, over Q12's UDF and a
    branching one: both compile, so the whole plan runs on the device
    (no row/columnar boundary, no fallback in ``explain()``); rows equal
    Q12's and the Python functions' applied row by row."""
    from spark_rapids_tpu_torch.exec import (ColumnarToRowExec,
                                             RowToColumnarExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.sql import session as S

    sess = S.TpuSession({"spark.rapids.tpu.sql.udfCompiler.enabled": True},
                        device=dev)
    xs = [None if z else int(v) for v, z in zip(x, xnull)]

    def q16():
        df = sess.create_dataframe({"k": k.tolist(), "x": xs}, schema)
        u1 = E.PythonUDF(udf_times_three_plus_one, (col("x"),))
        u2 = E.PythonUDF(udf_branch, (col("x"),))
        return (df.select(col("k"), E.Alias(u1, "u"), E.Alias(u2, "w"))
                .group_by("k").agg(A.agg(A.Sum(col("u")), "su"),
                                   A.agg(A.Count(col("u")), "cu"),
                                   A.agg(A.Sum(col("w")), "sw")))

    text = q16().explain()
    if "!" in text or "cannot run" in text:
        raise AssertionError(f"Q16 explain:\n{text}")
    want_u = {}
    want_w = {}
    for g, v in zip(k.tolist(), xs):
        if v is not None:
            want_u[g] = want_u.get(g, 0) + udf_times_three_plus_one(v)
            want_w[g] = want_w.get(g, 0) + udf_branch(v)
    want = [(g, su, cu, want_w.get(g)) for g, su, cu in q12_rows]
    if [(g, su) for g, su, _ in q12_rows] != [
            (g, want_u.get(g)) for g, _, _ in q12_rows]:
        raise AssertionError("Q16: Q12's rows differ from its Python UDF")

    def check(rows):
        if sorted(rows) != want:
            raise AssertionError("Q16: rows differ from Q12's or the "
                                 "Python functions'")

    cold, warm, counts = _walls(torch, "Q16", lambda: q16().collect(),
                                check)
    top = sess.last_executed_plan
    if not isinstance(top, ColumnarToRowExec) or any(
            isinstance(e, (RowToColumnarExec, ColumnarToRowExec))
            for e in _device_tree(top.tpu_child)):
        raise AssertionError(f"Q16 plan: {top.tree_string()}")
    if counts["bucket_sum"] <= 0:
        raise AssertionError("Q16 did not launch bucket_sum")
    emit({"query": "Q16", "rows": int(k.shape[0]), "groups": len(want),
          "cold_wall_ms": cold, "warm_wall_ms": warm,
          "explain": text.splitlines(),
          "plan": top.tree_string().splitlines(), "launches": counts})
    if profile:
        # the scan's upload happens while the plan is built, outside the
        # profiled collect()
        profile_plan(torch, "Q16", lambda: sess._execute(
            q16().node).tpu_child, sess.conf, int(k.shape[0]),
            int(k.shape[0]) * (4 + 8 + 2))
    return counts


def small_session_phase(torch, dev) -> dict:
    """range -> union -> local limit -> explode (posexplode) -> collect
    limit through the session on the card, held to the same query on the
    CPU engine (``spark.rapids.tpu.sql.enabled`` false); every operator
    must run on the device."""
    from spark_rapids_tpu_torch.exec.basic import (TpuCollectLimitExec,
                                                   TpuExpandExec,
                                                   TpuLocalLimitExec,
                                                   TpuRangeExec, TpuUnionExec)
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.sql import session as S

    def query(sess):
        df = sess.range(0, 1000, 3, num_slices=2).union(sess.range(5000, 5100))
        # 167 + 167 + 100 rows -> 100 a partition -> x2; the collect limit
        # ends at the second partition's end, because only there do both
        # engines' row sets agree: the device expands a batch per
        # projection and the CPU engine row by row (a divergence the
        # reference has too, ROADMAP.md section C)
        return (df.local_limit(100)
                .explode([col("id"), E.Multiply(col("id"), lit(-2))],
                         name="v", pos=True)
                .limit(400))

    sess = S.TpuSession({}, device=dev)
    cpu = S.TpuSession({"spark.rapids.tpu.sql.enabled": False}, device=dev)
    reset_launches()
    got = query(sess).collect()
    counts = launches()
    want = query(cpu).collect()
    if sorted(got) != sorted(want) or len(got) != 400:
        raise AssertionError("small phase: rows differ from the CPU engine")
    tree = list(_device_tree(sess.last_executed_plan.tpu_child))
    for kind in (TpuCollectLimitExec, TpuExpandExec, TpuLocalLimitExec,
                 TpuUnionExec, TpuRangeExec):
        if not any(isinstance(e, kind) for e in tree):
            raise AssertionError(f"small phase plan lacks {kind.__name__}")
    emit({"query": "small", "rows": len(got),
          "plan": sess.last_executed_plan.tree_string().splitlines(),
          "launches": counts})
    return counts


# ---------------------------------------------------------------------------
# string keys (Q17-Q19)
# ---------------------------------------------------------------------------
#: rows of Q17 (TPC-H lineitem at SF 1.4), Q18's fact (the bench join's)
#: and Q19 (a TPC-DS item-like table), as a power of two
STRING_LOG2_ROWS = 23
#: Q17's parquet file holds this many row groups (2^21 rows each at
#: full size): the scan hands the aggregate one batch per group
Q17_ROW_GROUPS = 4
#: Q18's fact rows arrive in this many probe batches
Q18_BATCHES = 4
#: TPC-H's flag and status values (spec 4.2.3), each sorted bytewise
RETURN_FLAGS = (b"A", b"N", b"R")
LINE_STATUS = (b"F", b"O")
#: TPC-H's seven l_shipmode values (spec 4.2.2.13)
SHIP_MODES = (b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL",
              b"FOB")
#: TPC-DS's ten i_category values
CATEGORIES = (b"Books", b"Children", b"Electronics", b"Home", b"Jewelry",
              b"Men", b"Music", b"Shoes", b"Sports", b"Women")
#: two-letter state codes (the 50 states and DC)
STATES = tuple(s.encode() for s in (
    "AK AL AR AZ CA CO CT DC DE FL GA HI IA ID IL IN KS KY LA MA MD ME MI "
    "MN MO MS MT NC ND NE NH NJ NM NV NY OH OK OR PA RI SC SD TN TX UT VA "
    "VT WA WI WV WY").split())
#: Q17's where clause: l_shipdate <= date '1998-12-01' - interval 90 days
Q17_CUTOFF = "1998-09-02"
Q17_DICT_OFF = "spark.rapids.tpu.sql.format.parquet.dictStrings.enabled"


def _days(np, iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def pool_planes(np, codes, pool, valid=None):
    """Arrow planes (offsets (n+1,) int64, chars) of rows that hold entry
    ``codes[i]`` of ``pool`` (bytes); null rows hold no bytes."""
    plens = np.array([len(b) for b in pool], np.int64)
    pstart = np.concatenate([[0], np.cumsum(plens)[:-1]])
    flat = np.frombuffer(b"".join(pool), np.uint8)
    lens = plens[codes] if valid is None else np.where(valid, plens[codes],
                                                       0)
    offsets = np.zeros(codes.size + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    src = (np.repeat(pstart[codes] - offsets[:-1], lens)
           + np.arange(offsets[-1]))
    return offsets, flat[src]


def _slice_planes(np, planes, a: int, b: int):
    """Rows [a, b) of a column: a numpy array, or an (offsets, chars)
    pair rebased to 0."""
    if isinstance(planes, tuple):
        off, chars = planes
        return off[a:b + 1] - off[a], chars[off[a]:off[b]]
    return planes[a:b]


def lineitem_table(np, n: int) -> dict:
    """TPC-H lineitem's Q1 columns, seeded (``rng(17)``), after the
    spec's rules (4.2.3): l_shipdate uniform over 1992-01-02..1998-12-01,
    l_receiptdate 1-30 days later; l_linestatus 'O' when shipped after
    the current date 1995-06-17, else 'F'; l_returnflag 'R' or 'A' when
    received by then, else 'N'; l_quantity 1-50; l_extendedprice the
    quantity times the part's retail price; l_discount 0.00-0.10;
    l_tax 0.00-0.08. Decimals are f64 and dates int32 days (the port has
    no decimal or date columns yet). Codes index RETURN_FLAGS,
    LINE_STATUS and SHIP_MODES."""
    rng = np.random.default_rng(17)
    ship = rng.integers(_days(np, "1992-01-02"), _days(np, "1998-12-01") + 1,
                        n).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n)
    current = _days(np, "1995-06-17")
    status = (ship > current).astype(np.int64)
    flag = np.where(receipt <= current, 2 * rng.integers(0, 2, n), 1)
    mode = rng.integers(0, len(SHIP_MODES), n)
    qty = rng.integers(1, 51, n).astype(np.float64)
    part = rng.integers(1, 280_001, n)
    retail = (90_000 + (part // 10) % 20_001 + 100 * (part % 1000)) / 100
    price = np.round(qty * retail, 2)
    disc = rng.integers(0, 11, n) / 100
    tax = rng.integers(0, 9, n) / 100
    return {"flag": flag, "status": status, "mode": mode, "qty": qty,
            "price": price, "disc": disc, "tax": tax, "ship": ship}


def _pa_strings(pa, np, planes):
    off, chars = planes
    return pa.Array.from_buffers(
        pa.string(), off.size - 1,
        [None, pa.py_buffer(off.astype(np.int32)), pa.py_buffer(chars)])


def q17_oracle(np, t: dict):
    """Q1's rows (numpy): per (flag, status) of the rows shipped by the
    cutoff, in that order: sums of qty, price, price*(1-disc) and
    price*(1-disc)*(1+tax), their magnitudes (for the tolerance), avg
    qty/price/disc, count, min and max l_shipmode."""
    keep = t["ship"] <= _days(np, Q17_CUTOFF)
    g = (t["flag"] * 2 + t["status"])[keep]
    dp = t["price"] * (1 - t["disc"])
    ch = dp * (1 + t["tax"])
    mode_rank = np.argsort(np.argsort(np.array(SHIP_MODES, "S7")))
    mr = mode_rank[t["mode"][keep]]
    by_rank = sorted(SHIP_MODES)
    rows = []
    for gid in np.unique(g):
        sel = g == gid
        cnt = int(sel.sum())
        sums = [float(np.sum(x[keep][sel])) for x in
                (t["qty"], t["price"], dp, ch)]
        mags = [float(np.sum(np.abs(x[keep][sel]))) for x in
                (t["qty"], t["price"], dp, ch)]
        avgs = [sums[0] / cnt, sums[1] / cnt,
                float(np.sum(t["disc"][keep][sel])) / cnt]
        rows.append((RETURN_FLAGS[gid // 2].decode(),
                     LINE_STATUS[gid % 2].decode(), sums, mags, avgs, cnt,
                     by_rank[int(mr[sel].min())].decode(),
                     by_rank[int(mr[sel].max())].decode()))
    return rows, int(keep.sum())


@functools.lru_cache(maxsize=1)
def lineitem_inputs(np, n: int):
    """Q17's and Q20's shared inputs, made once: the table, its oracle
    rows and kept-row count, and the three string columns' planes."""
    t = lineitem_table(np, n)
    want, kept = q17_oracle(np, t)
    strs = {"l_returnflag": pool_planes(np, t["flag"], RETURN_FLAGS),
            "l_linestatus": pool_planes(np, t["status"], LINE_STATUS),
            "l_shipmode": pool_planes(np, t["mode"], SHIP_MODES)}
    return t, want, kept, strs


def tpch_q1_df(np, sess, pdir, source=None):
    """TPC-H Q1 over the ``lineitem`` files under ``pdir`` (or over the
    DataFrame ``source``), as a port DataFrame (Q17, Q20, Q28)."""
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    price = col("l_extendedprice")
    disc_price = E.Multiply(price, E.Subtract(lit(1.0), col("l_discount")))
    charge = E.Multiply(disc_price, E.Add(lit(1.0), col("l_tax")))
    if source is None:
        source = sess.read.parquet(pdir)
    return (source
            .where(E.LessThanOrEqual(col("l_shipdate"),
                                     lit(_days(np, Q17_CUTOFF))))
            .group_by("l_returnflag", "l_linestatus")
            .agg(A.agg(A.Sum(col("l_quantity")), "sum_qty"),
                 A.agg(A.Sum(price), "sum_base_price"),
                 A.agg(A.Sum(disc_price), "sum_disc_price"),
                 A.agg(A.Sum(charge), "sum_charge"),
                 A.agg(A.Average(col("l_quantity")), "avg_qty"),
                 A.agg(A.Average(price), "avg_price"),
                 A.agg(A.Average(col("l_discount")), "avg_disc"),
                 A.agg(A.Count(None), "count_order"),
                 A.agg(A.Min(col("l_shipmode")), "min_mode"),
                 A.agg(A.Max(col("l_shipmode")), "max_mode"))
            .order_by("l_returnflag", "l_linestatus"))


def tpch_q1_check(want, rows, what):
    """Q1's rows against :func:`q17_oracle`'s: keys, counts and modes
    exact, sums within 1e-12 of each group's sum of |x|."""
    if len(rows) != len(want):
        raise AssertionError(f"{what}: {len(rows)} groups, expected "
                             f"{len(want)}")
    for r, (f, st, sums, mags, avgs, cnt, mn, mx) in zip(rows, want):
        if (r[0], r[1], r[9], r[10], r[11]) != (f, st, cnt, mn, mx):
            raise AssertionError(f"{what}: row {r[:2]} {r[9:]} != "
                                 f"{(f, st, cnt, mn, mx)}")
        for got, exp, mag in zip(r[2:6], sums, mags):
            if not _close(got, exp, mag, 1e-12):
                raise AssertionError(f"{what} {f}{st}: sum {got} != {exp}")
        for got, exp, mag in zip(r[6:9], avgs, [mags[0], mags[1],
                                                 mags[1]]):
            if not _close(got, exp, mag / cnt, 1e-12):
                raise AssertionError(f"{what} {f}{st}: avg {got} != {exp}")


def tpch_q1_chain(plan, what):
    """The executed plan of Q1: sort <- aggregate <- filter <- file scan,
    every exec on the device. Returns (aggregate, scan)."""
    from spark_rapids_tpu_torch.exec import (RowToColumnarExec,
                                             TpuFilterExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec

    top = plan.tpu_child
    chain = [top]
    while chain[-1].children:
        chain.append(chain[-1].children[0])
    kinds = (TpuSortExec, TpuHashAggregateExec, TpuFilterExec,
             TpuFileSourceScanExec)
    if len(chain) != len(kinds) or not all(
            isinstance(e, k) for e, k in zip(chain, kinds)) or any(
            isinstance(e, RowToColumnarExec) for e in chain):
        raise AssertionError(f"{what} plan: {top.tree_string()}")
    return chain[1], chain[3]


def q17_tpch_q1(torch, np, dev, log2_rows: int, reps: int, dadd_ns: float,
                profile: bool):
    """Q17, TPC-H Q1 (the pricing summary report) through a port
    ``TpuSession`` from parquet: see the module docstring. Both runs set
    variableFloatAgg (without it the planner keeps a float sum on the
    CPU, as the reference's type matrix does). Returns each run's
    launches (``Q17`` forces the SCATTER tier, ``Q17v`` takes AUTO, which
    resolves PALLAS on the card, ``Q17r`` forces RADIX: string keys take
    the sort path under all three, reduced with the order-preserving f64
    sums under SCATTER and on the RADIX kernel under PALLAS and RADIX),
    the ordered sum's numbers on the inputs one partial over a scan batch
    hands it in ``Q17`` and the RADIX kernel's on one partial's call in
    ``Q17v``."""
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.ops import groupby_kernels as K
    from spark_rapids_tpu_torch.ops import radix_kernels as RK
    from spark_rapids_tpu_torch.sql import session as S

    n = 1 << log2_rows
    t, want, kept, strs = lineitem_inputs(np, n)
    osum = radix = None
    here = os.path.dirname(os.path.abspath(__file__))
    pdir = os.path.join(here, PARQUET_DIR, "lineitem")
    shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)
    os.makedirs(pdir)
    per_query = {}
    nums = {"l_quantity": t["qty"], "l_extendedprice": t["price"],
            "l_discount": t["disc"], "l_tax": t["tax"],
            "l_shipdate": t["ship"]}
    try:
        pq.write_table(
            pa.table({**{k: _pa_strings(pa, np, v) for k, v in strs.items()},
                      **nums}),
            os.path.join(pdir, "t.parquet"),
            row_group_size=n // Q17_ROW_GROUPS,
            use_dictionary=list(nums))  # strings PLAIN-encoded

        def q17(sess):
            return tpch_q1_df(np, sess, pdir)

        def check(rows, what):
            tpch_q1_check(want, rows, what)

        vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
        for q, strategy in (("Q17", "SCATTER"), ("Q17v", "AUTO"),
                            ("Q17r", "RADIX")):
            sess = S.TpuSession({Q17_DICT_OFF: False, **vfa,
                                 "spark.rapids.tpu.sql.agg.strategy":
                                 strategy}, device=dev)
            DeviceScanCache.reset()
            S._SCANNER_CACHE.clear()
            plans = []

            def run_once():
                rows = q17(sess).collect()
                plans.append(sess.last_executed_plan)
                return rows

            routes = decode_routes()
            cold, warm, counts = _walls(torch, q, run_once,
                                        lambda rows: check(rows, q))
            routes = query_routes(q, routes)
            # the cold run's plan and metrics
            agg, scan = tpch_q1_chain(plans[0], q)
            batches = scan.metrics["numOutputBatches"].value
            # under SCATTER seven exact f64 sums (four sums, three
            # averages) per partial and once more in the merge, on the sort
            # path of string keys; under PALLAS and RADIX one RADIX
            # reduction each instead
            expected = ({"ordered_segment_sum": 7 * (batches + 1)}
                        if q == "Q17" else
                        {"radix_segment_reduce": batches + 1})
            if batches < 2 or {k: v for k, v in counts.items()
                               if v} != expected:
                raise AssertionError(
                    f"{q}: {batches} scan batches and launches {counts} "
                    f"(expected at least 2 and {expected})")
            if any(counts[k] for k in ("bucket_sum", "bucket_float_sum",
                                       "bucket_winner", "probe_ranges")):
                raise AssertionError(f"{q}: a hash-tier or join kernel "
                                     f"launched on the sort path: {counts}")
            per_query[q] = counts
            m = {k: v.value for k, v in scan.metrics.items()}
            in_bytes = n * (4 * 8 + 4) + sum(int(p[0][-1]) + 4 * n
                                             for p in strs.values())
            emit({"query": q, "rows": n, "kept_rows": kept,
                  "row_groups": Q17_ROW_GROUPS,
                  "scan_batches": batches, "groups": len(want),
                  "cold_wall_ms": cold, "warm_wall_ms": warm,
                  "host_fallback_chunks": m["hostFallbackChunks"],
                  "host_decode_ms": m["hostDecodeTime"] / 1e6,
                  "decode_routes": routes,
                  "upload_bytes": m["uploadBytes"],
                  "bytes": in_bytes, "bound_ms": bound_ms(in_bytes),
                  "agg": agg.describe(), "launches": counts})
            if profile:
                profile_plan(torch, q, lambda: sess._execute(
                    q17(sess).node).tpu_child, sess.conf, n, in_bytes,
                    SORT_KERNELS)
            if q == "Q17":
                # the ordered sum at Q17's shape: one more run, recording
                # the first call over a whole scan batch (a partial's
                # sum(l_quantity): the batch's four skewed segments)
                with captured_calls(K, "ordered_segment_sum",
                                    lambda v, sg, nseg: sg.shape[0] >= n
                                    // Q17_ROW_GROUPS) as calls:
                    check(q17(sess).collect(), q)
                if not calls:
                    raise AssertionError("Q17: no ordered sum over a scan "
                                         "batch")
                sv, sseg, nseg = calls[0]
                osum = ordered_sum_shape(torch, np, dev, sv, sseg, nseg,
                                         reps, dadd_ns)
                emit({"kernel_shape": "ordered_segment_sum", "path": "Q17",
                      "rows": sseg.shape[0], "B": nseg, **osum})
                del calls, sv, sseg
            if q == "Q17v":
                # the RADIX kernel at Q17v's shape: one more run, recording
                # the first call over a whole scan batch (a partial: four
                # groups, TPC-H Q1's eight aggregates)
                with captured_calls(RK, "segment_reduce",
                                    lambda p, *a: p.shape[0] >= n
                                    // Q17_ROW_GROUPS) as calls:
                    check(q17(sess).collect(), q)
                if not calls:
                    raise AssertionError("Q17v: no RADIX reduction over a "
                                         "scan batch")
                radix = radix_shape(torch, np, dev, *calls[0], reps, q)
                emit({"kernel_shape": "radix_segment_reduce", "path": q,
                      **radix})
                del calls
        emit({"host_decode": "Q17", **host_decode_timing(
            np, os.path.join(pdir, "t.parquet"))})
    finally:
        shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)
    return per_query, osum, radix


def q20_dict_tpch_q1(torch, np, dev, log2_rows: int, reps: int,
                     profile: bool):
    """Q20, TPC-H Q1 as files hold it: Q17's rows written by pyarrow with
    its default dictionary encoding on every column, read through a port
    ``TpuSession`` with default confs (``dictStrings`` on, so the three
    string columns scan as DictVs of the file's dictionaries) and
    variableFloatAgg, under SCATTER (Q20) and AUTO (Q20v, PALLAS on the
    card). The unique dictionary keys group on their codes: the direct
    tier, on K1 and K2 under PALLAS and on the plain reductions under
    SCATTER; l_shipmode's min/max reduce over its dictionary's ranks (K3
    under PALLAS). The merge of the four partials materializes their keys
    (each row group has its own dictionary) and takes the string sort
    path, its seven f64 sums on the ordered sum. Returns each run's
    launches and K1's and K2's numbers on their first call over a scan
    batch in Q20v."""
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.ops import groupby as G
    from spark_rapids_tpu_torch.ops import groupby_kernels as K
    from spark_rapids_tpu_torch.sql import session as S

    n = 1 << log2_rows
    t, want, kept, strs = lineitem_inputs(np, n)
    here = os.path.dirname(os.path.abspath(__file__))
    pdir = os.path.join(here, PARQUET_DIR, "lineitem_dict")
    shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)
    os.makedirs(pdir)
    per_query, shapes = {}, {}
    nums = {"l_quantity": t["qty"], "l_extendedprice": t["price"],
            "l_discount": t["disc"], "l_tax": t["tax"],
            "l_shipdate": t["ship"]}
    try:
        t0 = time.perf_counter()
        pq.write_table(
            pa.table({**{k: _pa_strings(pa, np, v) for k, v in strs.items()},
                      **nums}),
            os.path.join(pdir, "t.parquet"),
            row_group_size=n // Q17_ROW_GROUPS)  # pyarrow's defaults
        write_s = time.perf_counter() - t0
        vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
        for q, strategy in (("Q20", "SCATTER"), ("Q20v", "AUTO")):
            sess = S.TpuSession({**vfa, "spark.rapids.tpu.sql.agg.strategy":
                                 strategy}, device=dev)
            DeviceScanCache.reset()
            S._SCANNER_CACHE.clear()
            plans = []

            def run_once():
                rows = tpch_q1_df(np, sess, pdir).collect()
                plans.append(sess.last_executed_plan)
                return rows

            routes = decode_routes()
            cold, warm, counts = _walls(
                torch, q, run_once,
                lambda rows: tpch_q1_check(want, rows, q))
            routes = query_routes(q, routes)
            agg, scan = tpch_q1_chain(plans[0], q)
            desc = agg.describe()
            batches = scan.metrics["numOutputBatches"].value
            if f"update: {G.DICT_CODE_ROUTE}" not in desc:
                raise AssertionError(f"{q}: the keys did not group on their "
                                     f"dictionary codes: {desc}")
            # AUTO: the partials on the hash tiers' kernels, the merge's
            # materialized keys on the RADIX kernel
            kernels = ("bucket_sum", "bucket_float_sum", "bucket_winner",
                       "radix_segment_reduce")
            if batches < 2 or counts["probe_ranges"] or (
                    strategy == "AUTO" and not all(counts[k]
                                                   for k in kernels)) or (
                    strategy == "SCATTER" and any(counts[k]
                                                  for k in kernels)):
                raise AssertionError(f"{q}: {batches} scan batches, "
                                     f"launches {counts}")
            per_query[q] = counts
            m = {k: v.value for k, v in scan.metrics.items()}
            # the fixed-width columns, and int32 codes with validity per
            # string row (the dictionaries are a few bytes)
            in_bytes = n * (4 * 8 + 4) + 3 * 5 * n
            emit({"query": q, "rows": n, "kept_rows": kept,
                  "row_groups": Q17_ROW_GROUPS, "file_write_s": write_s,
                  "scan_batches": batches, "groups": len(want),
                  "cold_wall_ms": cold, "warm_wall_ms": warm,
                  "host_fallback_chunks": m["hostFallbackChunks"],
                  "host_decode_ms": m["hostDecodeTime"] / 1e6,
                  "decode_routes": routes,
                  "upload_bytes": m["uploadBytes"],
                  "bytes": in_bytes, "bound_ms": bound_ms(in_bytes),
                  "agg": desc, "launches": counts})
            if profile:
                profile_plan(torch, q, lambda: sess._execute(
                    tpch_q1_df(np, sess, pdir).node).tpu_child, sess.conf,
                    n, in_bytes, SORT_KERNELS)
            if q == "Q20v":
                # K1 and K2 at Q20v's shape: one more run, recording each
                # one's first call over a whole scan batch (a partial's
                # direct tier over the two code keys)
                def big(sg, *_):
                    return sg.shape[0] >= n // Q17_ROW_GROUPS

                with captured_calls(K, "bucket_sum", big) as c1, \
                        captured_calls(K, "bucket_float_sum", big) as c2:
                    tpch_q1_check(want, tpch_q1_df(np, sess, pdir)
                                  .collect(), q)
                if not c1 or not c2:
                    raise AssertionError("Q20v: no K1 or K2 call over a "
                                         "scan batch")
                seg, B = c1[0][0], c1[0][1]
                shapes[("bucket_sum", "Q20v")] = sum_shape(
                    torch, dev, *c1[0], reps)
                shapes[("bucket_float_sum", "Q20v")] = fsum_shape(
                    torch, dev, *c2[0], reps)
                for name in ("bucket_sum", "bucket_float_sum"):
                    emit({"kernel_shape": name, "path": "Q20v",
                          "rows": seg.shape[0], "B": B,
                          **shapes[(name, "Q20v")]})
                del c1, c2, seg
        emit({"host_decode": "Q20", **host_decode_timing(
            np, os.path.join(pdir, "t.parquet"))})
    finally:
        shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)
    return per_query, shapes


def city_pool(np) -> list:
    """600 city names of 4-20 bytes (seeded), sorted bytewise."""
    rng = np.random.default_rng(600)
    names = set()
    while len(names) < 600:
        w = rng.integers(ord("a"), ord("z") + 1,
                         int(rng.integers(4, 21))).astype(np.uint8)
        w[0] -= 32
        names.add(w.tobytes())
    return sorted(names)


def zip_tables(np, n: int, dim_rows: int) -> dict:
    """Q18's data (``rng(18)``): a dim of ``dim_rows`` unique 5-digit zip
    codes (in shuffled order) with a city from :func:`city_pool` and a
    state; a fact of ``n`` rows whose zip is a dim zip (93%), a 5-byte
    code absent from the dim (2%) or null (5%), and a net_paid."""
    rng = np.random.default_rng(18)
    dzip = rng.permutation(dim_rows)
    dcity = rng.integers(0, 600, dim_rows)
    dstate = rng.integers(0, len(STATES), dim_rows)
    fzip = rng.integers(0, dim_rows, n)
    absent = rng.random(n) < 0.02
    fzip[absent] = dim_rows + rng.integers(0, 10_000, int(absent.sum()))
    fnull = rng.random(n) < 0.05
    paid = np.round(rng.uniform(0.0, 300.0, n), 2)
    return {"dzip": dzip, "dcity": dcity, "dstate": dstate, "fzip": fzip,
            "fnull": fnull, "paid": paid}


def zip_pool(dim_rows: int) -> list:
    """The dim's zip codes ("00000".."99999" for 100 000 rows), then
    10 000 codes ("X0000".."X9999") no dim row holds."""
    return ([b"%05d" % i for i in range(dim_rows)]
            + [b"X%04d" % i for i in range(10_000)])


def q18_oracle(np, z: dict, cities: list, dim_rows: int) -> list:
    """(city, count, sum(net_paid), its magnitude, min(state),
    max(state)) per city of the inner join, sorted by city."""
    pos = np.empty(dim_rows, np.int64)
    pos[z["dzip"]] = np.arange(dim_rows)
    hit = ~z["fnull"] & (z["fzip"] < dim_rows)
    drow = pos[z["fzip"][hit]]
    city, state = z["dcity"][drow], z["dstate"][drow]
    cnt = np.bincount(city, minlength=600)
    tot = np.bincount(city, weights=z["paid"][hit], minlength=600)
    mn = np.full(600, len(STATES))
    mx = np.full(600, -1)
    np.minimum.at(mn, city, state)
    np.maximum.at(mx, city, state)
    return [(cities[c].decode(), int(cnt[c]), float(tot[c]), float(tot[c]),
             STATES[mn[c]].decode(), STATES[mx[c]].decode())
            for c in range(600) if cnt[c]]


def _string_sum(torch, c, n: int):
    """The sum of the bytes of a string column's first ``n`` rows."""
    pos = torch.arange(c.chars.shape[0], device=c.chars.device)
    return torch.where(pos < c.offsets[n], c.chars.to(torch.int64), 0).sum()


def key_byte_sums(np, keys):
    """The byte sum of each key's string ``b"K%09d" % key``."""
    digits = sum((keys // 10**i) % 10 for i in range(9))
    return ord("K") + 9 * ord("0") + digits


def _key_strings(np, keys, valid):
    """(offsets, chars) of ``b"K%09d" % key`` per row; null rows empty."""
    n = keys.size
    d = (keys[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + ord("0")
    rows = np.concatenate([np.full((n, 1), ord("K")), d], 1).astype(np.uint8)
    lens = np.where(valid, 10, 0)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return offsets, rows[valid].ravel()


def q18_string_join(torch, np, dev, log2_fact: int, dim_rows: int,
                    reps: int, dadd_ns: float, profile: bool):
    """Q18, a string-keyed equi-join with string payloads (TPC-DS q8/q24's
    join on a 5-digit zip), and Q18s, every join type over 10-byte keys;
    see the module docstring. Returns (per-path launches, K4's numbers
    on a Q18 probe batch, the ordered sum's on one partial of Q18)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec,
                                             TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.exec.base import vals_of_batch
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.ops import groupby_kernels as K
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops.filter_gather import live_of
    from spark_rapids_tpu_torch.ops.sort import (SortOrder, sort_permutation,
                                                 str_max_lens)

    per_query = {}
    n = 1 << log2_fact
    z = zip_tables(np, n, dim_rows)
    cities = city_pool(np)
    zips = zip_pool(dim_rows)
    want = q18_oracle(np, z, cities, dim_rows)
    fs = schema_of(zip=T.STRING, net_paid=T.DOUBLE)
    ds = schema_of(dzip=T.STRING, city=T.STRING, state=T.STRING)
    fzip = pool_planes(np, z["fzip"], zips, ~z["fnull"])
    per = n // Q18_BATCHES
    fact = [_padded_batch(np, torch, fs, [
        _slice_planes(np, fzip, i * per, (i + 1) * per),
        z["paid"][i * per:(i + 1) * per]],
        [~z["fnull"][i * per:(i + 1) * per], np.ones(per, bool)], dev)
        for i in range(Q18_BATCHES)]
    dcols = [pool_planes(np, z["dzip"], zips),
             pool_planes(np, z["dcity"], cities),
             pool_planes(np, z["dstate"], STATES)]
    dim = [_padded_batch(np, torch, ds, dcols,
                         [np.ones(dim_rows, bool)] * 3, dev)]
    in_bytes = (int(fzip[0][-1]) + n * (4 + 8 + 2)
                + sum(int(p[0][-1]) + 4 * dim_rows + dim_rows
                      for p in dcols))

    def plan(conf):
        join = TpuShuffledHashJoinExec(
            conf, InMemoryScanExec(conf, [fact], fs),
            InMemoryScanExec(conf, [dim], ds), [col("zip")], [col("dzip")],
            "inner")
        return join, TpuHashAggregateExec(
            conf, [col("city")],
            [A.agg(A.Count(None), "n"), A.agg(A.Sum(col("net_paid")), "s"),
             A.agg(A.Min(col("state")), "mn"),
             A.agg(A.Max(col("state")), "mx")], join)

    def check(rows, what):
        rows = sorted(rows)
        if len(rows) != len(want):
            raise AssertionError(f"{what}: {len(rows)} cities, expected "
                                 f"{len(want)}")
        for r, (c, k, s_, mag, mn, mx) in zip(rows, want):
            if (r[0], r[1], r[3], r[4]) != (c, k, mn, mx) or not _close(
                    r[2], s_, mag, 1e-12):
                raise AssertionError(f"{what}: {r} != {(c, k, s_, mn, mx)}")

    for q, strategy in (("Q18", "PALLAS"), ("Q18a", "AUTO")):
        conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": strategy})
        joins = []

        def run_once():
            join, agg = plan(conf)
            joins.append((join, agg))
            return _run(torch, agg, conf)[0]

        cold, warm, counts = _walls(torch, q, run_once,
                                    lambda rows: check(rows, q))
        k4 = counts["probe_ranges"]
        want_k4 = Q18_BATCHES if strategy == "PALLAS" else 0
        # one exact f64 sum per partial and one in the merge
        if k4 != want_k4 or counts["ordered_segment_sum"] != Q18_BATCHES + 1:
            raise AssertionError(f"{q}: launches {counts} (expected K4 "
                                 f"{want_k4}, ordered sums "
                                 f"{Q18_BATCHES + 1})")
        per_query[q] = counts
        emit({"query": q, "fact_rows": n, "dim_rows": dim_rows,
              "probe_batches": Q18_BATCHES, "groups": len(want),
              "cold_wall_ms": cold, "warm_wall_ms": warm,
              "join": joins[0][0].describe(), "agg": joins[0][1].describe(),
              "bytes": in_bytes, "bound_ms": bound_ms(in_bytes),
              "launches": counts})
        if profile:
            profile_plan(torch, q, lambda c=conf: plan(c)[1], conf, n,
                         in_bytes, SORT_KERNELS)
        if q == "Q18":
            # the ordered sum at Q18's shape: one more run, recording the
            # first call over a whole probe batch's join output (a
            # partial's sum(net_paid) over about 600 city segments)
            with captured_calls(K, "ordered_segment_sum",
                                lambda v, sg, nseg: sg.shape[0] >= per // 2
                                ) as calls:
                check(run_once(), q)
            if not calls:
                raise AssertionError("Q18: no ordered sum over a probe "
                                     "batch")
            osum = ordered_sum_shape(torch, np, dev, *calls[0][:2],
                                     calls[0][2], reps, dadd_ns)
            emit({"kernel_shape": "ordered_segment_sum", "path": "Q18",
                  "rows": calls[0][1].shape[0], "B": calls[0][2], **osum})
            del calls

    # K4 on string chunk words at Q18's shape: one probe batch's zips
    # against the dim's sorted zips (2 words each: 5 bytes, an 8-byte
    # bound), as the join hands them over
    dvals = vals_of_batch(dim[0])
    bcap = dim[0].capacity
    blive = live_of(dim_rows, bcap, dev)
    bml = str_max_lens([dvals[0]])
    bw, _ = J.radix_key_words([dvals[0]], [T.STRING], bml)
    perm = sort_permutation([dvals[0]], [T.STRING], [SortOrder(True, True)],
                            blive, bml)
    bw = [w[perm] for w in bw]
    pvals = vals_of_batch(fact[0])
    pw, pnull = J.radix_key_words([pvals[0]], [T.STRING],
                                  str_max_lens([pvals[0]]))
    plive = live_of(per, fact[0].capacity, dev) & ~pnull
    if len(bw) != 2 or len(pw) != 2:
        raise AssertionError(f"Q18 keys: {len(bw)} and {len(pw)} words")
    k4 = probe_timed(torch, bw, dim_rows, pw, plive, reps)
    emit({"kernel_shape": "probe_ranges", "path": "Q18", "probe_rows": per,
          "build_rows": bcap, "build_count": dim_rows, "words": 2, **k4})
    del fact, dim, dvals, pvals, bw, pw

    # --- Q18s: every join type over 10-byte keys (4 words: SEARCH) --------
    n8, d8 = 1 << (log2_fact - 3), 1 << (log2_fact - 7)
    r8 = np.random.default_rng(81)
    fk = r8.integers(0, 150_000, n8).astype(np.int64)
    fn = r8.random(n8) < 0.02
    fv = r8.integers(0, 100, n8).astype(np.int64)
    dk = r8.integers(0, 100_000, d8).astype(np.int64)
    dn = r8.random(d8) < 0.05
    dv = r8.integers(0, 10**6, d8).astype(np.int64)
    fs8 = schema_of(fk=T.STRING, fv=T.LONG)
    ds8 = schema_of(dk=T.STRING, dv=T.LONG)
    fact8 = [_padded_batch(np, torch, fs8, [_key_strings(np, fk, ~fn), fv],
                           [~fn, np.ones(n8, bool)], dev)]
    dim8 = [_padded_batch(np, torch, ds8, [_key_strings(np, dk, ~dn), dv],
                          [~dn, np.ones(d8, bool)], dev)]
    runs = {}
    counts8 = None
    for how in ("inner_cond", "left", "right", "full", "semi", "anti"):
        for strategy in ("PALLAS", "AUTO"):
            conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy":
                               strategy})
            cond = (E.GreaterThan(col("dv"), E.Multiply(col("fv"),
                                                        lit(10_000)))
                    if how == "inner_cond" else None)
            join = TpuShuffledHashJoinExec(
                conf, InMemoryScanExec(conf, [fact8], fs8),
                InMemoryScanExec(conf, [dim8], ds8), [col("fk")],
                [col("dk")], "inner" if cond is not None else how, cond)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = _reduce_join(torch, join)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = launches()
            exp = _join_oracle(
                np, fk, fv, fn, dk, dv, dn,
                "inner" if cond is not None else how,
                (lambda v: v * 10_000) if cond is not None else None,
                key_byte_sums(np, fk), key_byte_sums(np, dk))
            if got != exp:
                raise AssertionError(f"Q18s {how} {strategy}: {got} != "
                                     f"{exp}")
            if any(counts.values()):
                raise AssertionError(f"Q18s {how} {strategy} launched "
                                     f"{counts}: 4-word keys take SEARCH")
            runs[f"{how}/{strategy}"] = {"rows": got[0], "wall_ms": ms,
                                         "join": join.describe()}
            counts8 = counts
    per_query["Q18s"] = counts8
    emit({"query": "Q18s", "fact_rows": n8, "dim_rows": d8, "key_bytes": 10,
          "runs": runs, "launches": counts8})
    return per_query, k4, osum


ITEM_PREFIX = b"AAAAAAAA"


@functools.lru_cache(maxsize=1)
def item_table(np, n: int) -> dict:
    """Q19's TPC-DS item-like rows (``rng(19)``): i_item_id is
    "AAAAAAAA" and eight letters A-P (dsdgen's business keys) spelling a
    random 32-bit number ``id`` (so byte order is ``id`` order); a
    category code into CATEGORIES; i_brand_id in [1, 1000]; sales."""
    rng = np.random.default_rng(19)
    ids = rng.integers(0, 2**32, n, dtype=np.int64)
    cat = rng.integers(0, len(CATEGORIES), n)
    brand = rng.integers(1, 1001, n).astype(np.int32)
    sales = rng.integers(0, 10**6, n).astype(np.int64)
    return {"id": ids, "cat": cat, "brand": brand, "sales": sales}


def item_id_planes(np, ids):
    n = ids.size
    letters = (ids[:, None] >> (4 * np.arange(7, -1, -1))) & 15
    rows = np.concatenate([np.full((n, 8), ord("A")), letters + ord("A")],
                          1).astype(np.uint8)
    return np.arange(n + 1, dtype=np.int64) * 16, rows.ravel()


def item_id(i: int) -> str:
    return (ITEM_PREFIX + bytes(ord("A") + ((i >> (4 * k)) & 15)
                                for k in range(7, -1, -1))).decode()


#: Q19(c)'s launches at full size (STRING_LOG2_ROWS), as the H100 run of
#: this script reports them: 1000 brands miss the 128-bucket hash tier
#: (K1 once, K3 for min, max and the representative row) and fit the
#: 1024-bucket direct tier (K1 once, K3 for min and max)
Q19C_LAUNCHES = {"bucket_sum": 2, "bucket_float_sum": 0,
                 "bucket_winner": 5, "ordered_segment_sum": 0,
                 "probe_ranges": 0, "word_counts": 0,
                 "dfa_accept_rows": 0, "radix_segment_reduce": 0}


def q19_item_keys(torch, np, dev, log2_rows: int, reps: int,
                  profile: bool):
    """Q19: string sort and window keys and string min/max over an item
    table; see the module docstring. Returns (per-path launches, K3's
    numbers on Q19(c)'s rank column, K1's on the direct tier's call in
    Q19(c))."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.exec.base import vals_of_batch
    from spark_rapids_tpu_torch.exec.basic import TpuLocalLimitExec
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    from spark_rapids_tpu_torch.exec.window import TpuWindowExec
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr import windows as W
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.ops import groupby as G
    from spark_rapids_tpu_torch.ops import groupby_kernels as K
    from spark_rapids_tpu_torch.ops.sort import str_max_lens

    n = 1 << log2_rows
    t = item_table(np, n)
    ids, cat, brand, sales = t["id"], t["cat"], t["brand"], t["sales"]
    schema = schema_of(i_item_id=T.STRING, i_category=T.STRING,
                       i_brand_id=T.INT, sales=T.LONG)
    planes = [item_id_planes(np, ids), pool_planes(np, cat, CATEGORIES),
              brand, sales]
    batch = _padded_batch(np, torch, schema, planes, [np.ones(n, bool)] * 4,
                          dev)
    conf = RapidsConf({})
    in_bytes = n * (16 + 4 + 4 + 8) + int(planes[1][0][-1]) + 4 * n + 4 * n
    idx = np.arange(n)
    cats = [c.decode() for c in CATEGORIES]
    per_query = {}

    def row(i, *extra):
        return (item_id(int(ids[i])), cats[cat[i]], int(brand[i]),
                int(sales[i])) + extra

    def scan():
        return InMemoryScanExec(conf, [[batch]], schema)

    # (a) order by i_item_id desc limit 100
    top = np.lexsort((idx, -ids))[:100]
    want_a = [row(i) for i in top]

    def plan_a():
        return TpuLocalLimitExec(conf, 100, TpuSortExec(
            conf, [col("i_item_id")], [(False, None)], scan()))

    # (b) rank() over (partition by i_category order by sales desc) <= 3
    order = np.lexsort((idx, -sales, cat))
    cs, ss = cat[order], sales[order]
    new_part = np.r_[True, cs[1:] != cs[:-1]]
    new_peer = new_part | np.r_[True, ss[1:] != ss[:-1]]
    pos = np.arange(n)
    rk = (np.maximum.accumulate(np.where(new_peer, pos, 0))
          - np.maximum.accumulate(np.where(new_part, pos, 0)) + 1)
    want_b = [row(i, int(r)) for i, r in zip(order[rk <= 3], rk[rk <= 3])]

    def plan_b():
        spec = W.WindowSpec(partition_by=(col("i_category"),),
                            order_by=(col("sales"),), orders=((False, None),))
        win = TpuWindowExec(conf, [W.WindowExpression(W.Rank(), spec, "rk")],
                            scan())
        return TpuFilterExec(conf, E.LessThanOrEqual(col("rk"), lit(3)), win)

    # (c) group by i_brand_id: min/max(i_item_id), count(*)
    bo = np.lexsort((ids, brand))
    b_sorted, id_sorted = brand[bo], ids[bo]
    first = np.r_[True, b_sorted[1:] != b_sorted[:-1]]
    last = np.r_[first[1:], True]
    want_c = [(int(b_sorted[i]), item_id(int(id_sorted[i])),
               item_id(int(id_sorted[j])), int(c_))
              for i, j, c_ in zip(np.nonzero(first)[0], np.nonzero(last)[0],
                                  np.bincount(brand, minlength=1001)[
                                      np.unique(brand)])]

    def plan_c():
        return TpuHashAggregateExec(
            conf, [col("i_brand_id")],
            [A.agg(A.Min(col("i_item_id")), "mn"),
             A.agg(A.Max(col("i_item_id")), "mx"),
             A.agg(A.Count(None), "n")], scan())

    aggs = []

    def run_c():
        agg = plan_c()
        aggs.append(agg)
        return sorted(_run(torch, agg, conf)[0])

    for q, run, want in (
            ("Q19a", lambda: _run(torch, plan_a(), conf)[0], want_a),
            ("Q19b", lambda: _run(torch, plan_b(), conf)[0], want_b),
            ("Q19c", run_c, want_c)):
        def check(rows, q=q, want=want):
            if rows != want:
                raise AssertionError(f"{q}: rows differ from the numpy "
                                     "oracle")

        cold, warm, counts = _walls(torch, q, run, check)
        per_query[q] = counts
        if q != "Q19c" and any(counts.values()):
            raise AssertionError(f"{q} launched {counts}")
        line = {"query": q, "rows": n, "out_rows": len(want),
                "cold_wall_ms": cold, "warm_wall_ms": warm,
                "bytes": in_bytes, "bound_ms": bound_ms(in_bytes),
                "launches": counts}
        if q == "Q19c":
            line["agg"] = aggs[0].describe()
            if counts["bucket_winner"] <= 0 or (
                    n == 1 << STRING_LOG2_ROWS and counts != Q19C_LAUNCHES):
                raise AssertionError(f"Q19c launches {counts} (expected K3 "
                                     f"on the rank columns: "
                                     f"{Q19C_LAUNCHES})")
        emit(line)
        if profile:
            profile_plan(torch, q, {"Q19a": plan_a, "Q19b": plan_b,
                                    "Q19c": plan_c}[q], conf, n, in_bytes,
                         SORT_KERNELS)

    # K1 at Q19(c)'s shape: one more run, recording the direct tier's
    # call (1024 buckets, brand ids 1..1000) as the aggregate makes it
    with captured_calls(K, "bucket_sum",
                        lambda sg, B, ic, cc: B == 1024) as calls:
        if run_c() != want_c:
            raise AssertionError("Q19c: rows differ from the numpy oracle")
    if not calls:
        raise AssertionError("Q19c: K1 made no call on the direct tier")
    k1 = sum_shape(torch, dev, *calls[0], reps)
    emit({"kernel_shape": "bucket_sum", "path": "Q19c", "rows": n,
          "B": 1024, **k1})
    del calls

    # K3 on a rank column at Q19(c)'s shape: i_item_id's ranks over the
    # direct tier's 1024 buckets (brand ids 1..1000), min's order words
    vals = vals_of_batch(batch)
    _, rank = G._plain_rank(vals[0], n, str_max_lens([vals[0]])[0])
    seg = torch.where(vals[2].validity, vals[2].data, 1024).to(torch.int32)
    word = K._order_words(rank.data, ~rank.validity, "min")
    k3 = winner_shape(torch, dev, seg, 1024, "min", word, reps)
    emit({"kernel_shape": "bucket_winner", "path": "Q19c", "rows": n,
          "B": 1024, **k3})
    return per_query, k3, k1


#: the syllables dsdgen builds TPC-DS names from
SYLLABLES = ("able", "anti", "bar", "cally", "ation", "eing", "n st",
             "ought", "pri", "ese")


def brand_name(i: int) -> bytes:
    """The i_brand of brand id ``i`` (1-1000), dsdgen-like: three
    syllables from its digits and " #" and the id, so byte order is not
    id order."""
    return (SYLLABLES[i // 100 % 10] + SYLLABLES[i // 10 % 10]
            + SYLLABLES[i % 10] + f" #{i}").encode()


def q21_dict_item(torch, np, dev, log2_rows: int, reps: int,
                  profile: bool):
    """Q21: Q19's item table with i_category (TPC-DS's ten names) and
    i_brand (one per i_brand_id, 1000 entries in id order) as
    dictionary-encoded columns with ``unique`` set. (a) group by
    i_category: min(i_brand), max(i_brand), count(*), sum(sales) under
    AUTO (PALLAS on the card): the category codes on the direct tier (K1),
    i_brand's min and max over the ranks of a sort of its 1000-entry
    dictionary (K3); (b) order by i_category, i_brand, local limit 100:
    the sort materializes both. Each against an exact numpy oracle.
    Returns (per-path launches, K3's numbers on its first call over
    Q21(a)'s rank column)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import (ColumnarBatch, DeviceColumn,
                                                 HostColumn, choose_capacity,
                                                 schema_of)
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.exec.basic import TpuLocalLimitExec
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.ops import groupby as G
    from spark_rapids_tpu_torch.ops import groupby_kernels as K

    n = 1 << log2_rows
    t = item_table(np, n)
    cat, brand, sales = t["cat"], t["brand"], t["sales"]
    cap = choose_capacity(n)
    names = [brand_name(i) for i in range(1, 1001)]

    schema = schema_of(i_category=T.STRING, i_brand=T.STRING,
                       i_brand_id=T.INT, sales=T.LONG)
    batch = ColumnarBatch([
        dict_item_col(np, dev, cat, list(CATEGORIES), n, cap),
        dict_item_col(np, dev, brand - 1, names, n, cap),
        DeviceColumn.from_host(HostColumn(T.INT, brand, np.ones(n, bool)),
                               cap, "i_brand_id", dev),
        DeviceColumn.from_host(HostColumn(T.LONG, sales, np.ones(n, bool)),
                               cap, "sales", dev)], schema, n)
    conf = RapidsConf({})
    # codes and validity of the two string columns, the fixed-width ones
    # with their validity, and the two dictionaries
    in_bytes = n * (5 + 5 + 5 + 9) + sum(len(e) for e in CATEGORIES) + sum(
        len(e) for e in names) + 4 * (10 + 1000 + 2)

    def scan():
        return InMemoryScanExec(conf, [[batch]], schema)

    # (a) group by i_category: min/max(i_brand), count(*), sum(sales)
    by_rank = sorted(names)
    rk = np.argsort(np.argsort(np.array(names, dtype=object)))[brand - 1]
    want_a = []
    for g in range(len(CATEGORIES)):
        sel = cat == g
        want_a.append((CATEGORIES[g].decode(),
                       by_rank[int(rk[sel].min())].decode(),
                       by_rank[int(rk[sel].max())].decode(),
                       int(sel.sum()), int(sales[sel].sum())))

    def plan_a():
        return TpuHashAggregateExec(
            conf, [col("i_category")],
            [A.agg(A.Min(col("i_brand")), "mn"),
             A.agg(A.Max(col("i_brand")), "mx"),
             A.agg(A.Count(None), "n"), A.agg(A.Sum(col("sales")), "s")],
            scan())

    # (b) order by i_category, i_brand limit 100 (stable: row order breaks
    # ties)
    top = np.lexsort((np.arange(n), rk, cat))[:100]
    want_b = [(CATEGORIES[cat[i]].decode(), names[brand[i] - 1].decode(),
               int(brand[i]), int(sales[i])) for i in top]

    def plan_b():
        return TpuLocalLimitExec(conf, 100, TpuSortExec(
            conf, [col("i_category"), col("i_brand")],
            [(True, None), (True, None)], scan()))

    aggs = []

    def run_a():
        agg = plan_a()
        aggs.append(agg)
        return sorted(_run(torch, agg, conf)[0])

    per_query = {}
    for q, run, want in (("Q21a", run_a, want_a),
                         ("Q21b", lambda: _run(torch, plan_b(), conf)[0],
                          want_b)):
        def check(rows, q=q, want=want):
            if rows != want:
                raise AssertionError(f"{q}: rows differ from the numpy "
                                     "oracle")

        cold, warm, counts = _walls(torch, q, run, check)
        per_query[q] = counts
        line = {"query": q, "rows": n, "out_rows": len(want),
                "cold_wall_ms": cold, "warm_wall_ms": warm,
                "bytes": in_bytes, "bound_ms": bound_ms(in_bytes),
                "launches": counts}
        if q == "Q21a":
            line["agg"] = aggs[0].describe()
            if (f"update: {G.DICT_CODE_ROUTE}" not in line["agg"]
                    or counts["bucket_sum"] <= 0
                    or counts["bucket_winner"] <= 0
                    or counts["ordered_segment_sum"]):
                raise AssertionError(f"Q21a: launches {counts}, "
                                     f"{line['agg']}")
        elif any(counts.values()):
            raise AssertionError(f"{q} launched {counts}")
        emit(line)
        if profile:
            profile_plan(torch, q, {"Q21a": plan_a, "Q21b": plan_b}[q],
                         conf, n, in_bytes, SORT_KERNELS)

    # K3 on Q21(a)'s rank column: one more run, recording its first call
    # over the whole batch (min(i_brand)'s order words of the ranks over
    # the category codes' direct-tier buckets)
    with captured_calls(K, "bucket_winner",
                        lambda sg, B, op, w: sg.shape[0] >= n) as calls:
        if run_a() != want_a:
            raise AssertionError("Q21a: rows differ from the numpy oracle")
    if not calls:
        raise AssertionError("Q21a: K3 made no call over the batch")
    seg, B, op, word = calls[0]
    k3 = winner_shape(torch, dev, seg, B, op, word, reps)
    emit({"kernel_shape": "bucket_winner", "path": "Q21a", "rows": n,
          "B": B, "op": op, **k3})
    return per_query, k3


def string_key_phase(torch, np, dev, log2_rows: int, dim_rows: int,
                     reps: int, dadd_ns: float, profile: bool = False):
    """Q17-Q19 at ``log2_rows`` rows (Q18's dim: ``dim_rows``): each
    path's launches, and the kernels' numbers at the shapes these paths
    give them, keyed as in ``kernels_line``: the ordered sum's at Q17's
    and Q18's, K4's at Q18's, K1's and K3's at Q19(c)'s."""
    per_query, osum, radix = q17_tpch_q1(torch, np, dev, log2_rows, reps,
                                         dadd_ns, profile)
    q18, k4, osum18 = q18_string_join(torch, np, dev, log2_rows, dim_rows,
                                      reps, dadd_ns, profile)
    q19, k3, k1 = q19_item_keys(torch, np, dev, log2_rows, reps, profile)
    per_query.update(q18)
    per_query.update(q19)
    return per_query, {("ordered_segment_sum", "Q17"): osum,
                       ("radix_segment_reduce", 128): radix,
                       ("ordered_segment_sum", "Q18"): osum18,
                       ("probe_ranges", "Q18"): k4,
                       ("bucket_sum", "Q19c"): k1,
                       ("bucket_winner", "Q19c"): k3}


def dict_string_phase(torch, np, dev, log2_rows: int, reps: int,
                      profile: bool = False):
    """Q20 and Q21 at ``log2_rows`` rows: each path's launches, and K1's
    and K2's numbers at Q20v's direct tier and K3's on Q21(a)'s
    dictionary ranks, keyed as in ``kernels_line``."""
    per_query, shapes = q20_dict_tpch_q1(torch, np, dev, log2_rows, reps,
                                         profile)
    q21, k3 = q21_dict_item(torch, np, dev, log2_rows, reps, profile)
    per_query.update(q21)
    shapes[("bucket_winner", "Q21a")] = k3
    return per_query, shapes


# ---------------------------------------------------------------------------
# the other string expressions (item 15): the DFA kernel, Q22-Q24
# ---------------------------------------------------------------------------
#: TPC-H's text grammar (spec 4.2.2.12-13), the word lists as kept here
TEXT_NOUNS = (
    "foxes", "ideas", "theodolites", "pinto beans", "instructions",
    "dependencies", "excuses", "platelets", "asymptotes", "courts",
    "dolphins", "multipliers", "sauternes", "warthogs", "frets", "dinos",
    "attainments", "somas", "Tiresias", "patterns", "forges", "braids",
    "hockey players", "frays", "warhorses", "dugouts", "notornis",
    "epitaphs", "pearls", "tithes", "waters", "orbits", "gifts", "sheaves",
    "depths", "sentiments", "decoys", "realms", "pains", "grouches",
    "escapades", "packages", "requests", "accounts", "deposits")
TEXT_VERBS = (
    "sleep", "wake", "are", "cajole", "haggle", "nag", "use", "boost",
    "affix", "detect", "integrate", "maintain", "nod", "was", "lose",
    "sublate", "solve", "thrash", "promise", "engage", "hinder", "print",
    "x-ray", "breach", "eat", "grow", "impress", "mold", "poach", "serve",
    "run", "dazzle", "snooze", "doze", "unwind", "kindle", "play", "hang",
    "believe", "doubt")
TEXT_ADJECTIVES = (
    "special", "pending", "unusual", "express", "furious", "sly",
    "careful", "blithe", "quick", "fluffy", "slow", "quiet", "ruthless",
    "thin", "close", "dogged", "daring", "brave", "stealthy", "permanent",
    "enticing", "idle", "busy", "regular", "final", "ironic", "even",
    "bold", "silent")
TEXT_ADVERBS = (
    "sometimes", "always", "never", "furiously", "slyly", "carefully",
    "blithely", "quickly", "fluffily", "slowly", "quietly", "ruthlessly",
    "thinly", "closely", "doggedly", "daringly", "bravely", "stealthily",
    "permanently", "enticingly", "idly", "busily", "regularly", "finally",
    "ironically", "evenly", "boldly", "silently")
TEXT_PREPOSITIONS = (
    "about", "above", "according to", "across", "after", "against",
    "along", "alongside of", "among", "around", "at", "atop", "before",
    "behind", "beneath", "beside", "besides", "between", "beyond", "by",
    "despite", "during", "except", "for", "from", "in place of", "inside",
    "instead of", "into", "near", "of", "on", "outside", "over", "past",
    "since", "through", "throughout", "to", "toward", "under", "until",
    "up", "upon", "without", "with", "within")
TEXT_AUXILIARIES = (
    "do", "may", "might", "shall", "will", "would", "can", "could",
    "should", "ought to", "must", "will have to", "shall have to",
    "could have to", "should have to", "must have to", "need to", "try to")
TEXT_TERMINATORS = (".", ";", ":", "?", "!", "--")
#: bytes of the text pool the comments are cut from (dbgen's is 300 MB)
TEXT_POOL_BYTES = 1 << 21
#: Q22-Q24's orders (2^23: TPC-H SF 5.59 at 1.5M orders a unit; its
#: customers are a tenth of them, 838 861), in four row groups
ORDERS_LOG2_ROWS = 23
ORDERS_ROW_GROUPS = 4
#: Q22's LIKE (TPC-H Q13's WORD1 = special, WORD2 = requests), Q22r's
#: RLIKE of the same words (beyond the 16-state DFA: it falls back), and
#: Q22d's pattern, which the DFA takes
Q22_LIKE = "%special%requests%"
Q22R_REGEX = "special.*requests"
Q22D_REGEX = "^[a-z]+ (sly|furious)"
#: TPC-H Q22's country codes (its default substitution parameters)
Q23_CODES = ("13", "31", "23", "29", "30", "18", "17")
#: the kernel phase's patterns beside Q22D_REGEX: anchored, '$' over rows
#: that end in '\n', and a class that takes multi-byte UTF-8
DFA_PATTERNS = ("^[a-z]+ [0-9]", "s$", "[^ -~]")


def text_pool(np) -> bytes:
    """Sentences of TPC-H's text grammar (spec 4.2.2.12: noun phrase,
    verb phrase, optional prepositional or noun phrase, terminator),
    seeded (``rng(22)``), to ``TEXT_POOL_BYTES`` bytes."""
    rng = np.random.default_rng(22)
    out, size = [], 0

    def pick(words):
        return words[int(rng.integers(0, len(words)))]

    def noun_phrase():
        form = int(rng.integers(0, 4))
        if form == 0:
            return pick(TEXT_NOUNS)
        if form == 1:
            return f"{pick(TEXT_ADJECTIVES)} {pick(TEXT_NOUNS)}"
        if form == 2:
            return (f"{pick(TEXT_ADJECTIVES)}, {pick(TEXT_ADJECTIVES)} "
                    f"{pick(TEXT_NOUNS)}")
        return f"{pick(TEXT_ADVERBS)} {pick(TEXT_ADJECTIVES)} " \
               f"{pick(TEXT_NOUNS)}"

    def verb_phrase():
        form = int(rng.integers(0, 4))
        v = pick(TEXT_VERBS)
        if form == 1:
            v = f"{pick(TEXT_AUXILIARIES)} {v}"
        elif form == 2:
            v = f"{v} {pick(TEXT_ADVERBS)}"
        elif form == 3:
            v = f"{pick(TEXT_AUXILIARIES)} {v} {pick(TEXT_ADVERBS)}"
        return v

    def prep_phrase():
        return f"{pick(TEXT_PREPOSITIONS)} the {noun_phrase()}"

    while size < TEXT_POOL_BYTES:
        form = int(rng.integers(0, 5))
        parts = [noun_phrase()]
        if form >= 3:
            parts.append(prep_phrase())
        parts.append(verb_phrase())
        if form in (1, 4):
            parts.append(prep_phrase())
        elif form in (2, 3):
            parts.append(noun_phrase())
        s = " ".join(parts) + pick(TEXT_TERMINATORS) + " "
        out.append(s)
        size += len(s)
    return "".join(out).encode()[:TEXT_POOL_BYTES]


@functools.lru_cache(maxsize=1)
def tpch_orders_customers(np, n: int) -> dict:
    """TPC-H's ``orders`` (o_orderkey 1..n, o_custkey never a multiple of
    3, so one customer in three has no orders, spec 4.2.3) and
    ``customer`` (n / 10 rows, as TPC-H's ratio: c_nationkey 0-24, c_phone
    "CC-NNN-NNN-NNNN" with CC = nationkey + 10, c_acctbal uniform over
    -999.99..9999.99 in cents; decimals as f64), seeded (``rng(23)``).
    o_comment is dbgen-like: a random 19-78-byte slice of
    :func:`text_pool` (dbgen cuts its comments from a text pool too).
    Returns the columns, the comments as (offsets, slice start, length)
    into the pool, and the pool."""
    rng = np.random.default_rng(23)
    pool = np.frombuffer(text_pool(np), np.uint8)
    nc = int(round(n / 10))
    m = rng.integers(0, nc - nc // 3, n)
    custkey = (m // 2) * 3 + 1 + m % 2
    lens = rng.integers(19, 79, n)
    start = rng.integers(0, pool.size - 79, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    nation = rng.integers(0, 25, nc)
    parts = [nation + 10, rng.integers(100, 1000, nc),
             rng.integers(100, 1000, nc),
             rng.integers(1000, 10000, nc)]
    phone = np.full((nc, 15), ord("-"), np.uint8)
    at = 0
    for p, w in zip(parts, (2, 3, 3, 4)):
        phone[:, at:at + w] = (p[:, None] // 10 ** np.arange(w - 1, -1, -1)
                               ) % 10 + ord("0")
        at += w + 1
    acctbal = rng.integers(-99_999, 1_000_000, nc) / 100
    return {"n": n, "customers": nc,
            "orderkey": np.arange(1, n + 1, dtype=np.int64),
            "custkey": custkey.astype(np.int64), "offsets": offsets,
            "start": start, "lens": lens, "pool": pool,
            "c_custkey": np.arange(1, nc + 1, dtype=np.int64),
            "nation": nation.astype(np.int32),
            "phone": (np.arange(nc + 1, dtype=np.int64) * 15,
                      phone.ravel()),
            "acctbal": acctbal}


def comment_chars(torch, t, dev):
    """o_comment's bytes on ``dev``: each row's slice of the text pool,
    one gather."""
    pool = torch.from_numpy(t["pool"].copy()).to(dev)
    lens = torch.from_numpy(t["lens"]).to(dev)
    off = torch.from_numpy(t["offsets"]).to(dev)
    start = torch.from_numpy(t["start"]).to(dev)
    total = int(t["offsets"][-1])
    src = torch.repeat_interleave(start - off[:-1], lens, output_size=total)
    return pool[src + torch.arange(total, device=dev)]


def _starts_of(np, pool, word: bytes):
    """Sorted positions where ``word`` starts in ``pool``."""
    m = pool.size - len(word) + 1
    hits = np.ones(m, bool)
    for k, b in enumerate(word):
        hits &= pool[k:k + m] == b
    return np.flatnonzero(hits)


def like_oracle(np, t):
    """Per order: does o_comment match Q22_LIKE (``special`` then, not
    overlapping, ``requests``)? From the pool positions of the two words:
    the first ``special`` at or after the row's start must end before
    the last ``requests`` that ends inside the row."""
    o, end = t["start"], t["start"] + t["lens"]
    ps = _starts_of(np, t["pool"], b"special")
    pr = _starts_of(np, t["pool"], b"requests")
    i = np.searchsorted(ps, o, "left")
    first = np.where(i < ps.size, ps[np.minimum(i, ps.size - 1)], 2**62)
    j = np.searchsorted(pr, end - 8, "right") - 1
    last = np.where(j >= 0, pr[np.maximum(j, 0)], -1)
    return first + 7 <= last


def anchored_oracle(np, t):
    """Per order: does o_comment match Q22D_REGEX? Its first word must be
    lowercase letters, and the next bytes " sly" or " furious" inside the
    row."""
    pool = t["pool"]
    o, end = t["start"], t["start"] + t["lens"]
    stop = np.flatnonzero((pool < ord("a")) | (pool > ord("z")))
    q = stop[np.minimum(np.searchsorted(stop, o, "left"), stop.size - 1)]
    sly = np.isin(q, _starts_of(np, pool, b" sly")) & (q + 4 <= end)
    fur = np.isin(q, _starts_of(np, pool, b" furious")) & (q + 8 <= end)
    return (q > o) & (sly | fur)


def check_text_oracles(np, t, like, anchored, rows: int = 4096) -> None:
    """The two oracles against Python's ``re`` on a seeded sample."""
    import re

    rng = np.random.default_rng(25)
    for i in rng.integers(0, t["n"], rows):
        s = t["pool"][t["start"][i]:t["start"][i] + t["lens"][i]].tobytes(
        ).decode()
        if (bool(re.search("special.*requests", s)) != bool(like[i])
                or bool(re.match(Q22D_REGEX, s)) != bool(anchored[i])):
            raise AssertionError(f"text oracle disagrees with re on {s!r}")


def q13_oracle(np, t, excluded) -> list:
    """TPC-H Q13's rows: (c_count, custdist) by custdist DESC, c_count
    DESC, the orders whose comment matched left out."""
    nc = t["customers"]
    cnt = np.bincount(t["custkey"][~excluded], minlength=nc + 1)[1:]
    dist = np.bincount(cnt)
    return sorted(((c, int(d)) for c, d in enumerate(dist) if d),
                  key=lambda r: (-r[1], -r[0]))


#: rows of the DFA kernel's uneven shape, each 2^10..2^16 bytes of the
#: text pool (about Q22's 407 MB of comments in all)
DFA_UNEVEN_ROWS = 3 << 12
DFA_UNEVEN_LENS = (1 << 10, 1 << 16)


def dfa_ptxas() -> list:
    """ptxas' lines for the DFA kernel from the build this process
    loaded: registers, shared memory, spills."""
    from spark_rapids_tpu_torch.ops import regex_kernels as RK

    return [ln.strip() for ln in "".join(RK.BUILD_LOG).splitlines()
            if "dfa_accept_rows" in ln or "registers" in ln
            or "spill" in ln]


def walked_sectors(torch, offsets, steps) -> int:
    """Distinct 32-byte sectors of the pool that hold a walked byte (each
    row's first ``steps`` bytes from its offset): what device memory must
    move for them, since it moves whole sectors."""
    lo = offsets[:-1].long()
    m = steps > 0
    first = lo[m] >> 5
    cnt = ((lo[m] + steps[m] - 1) >> 5) - first + 1
    if not int(cnt.numel()):
        return 0
    total = int(cnt.sum())
    start = torch.cumsum(cnt, 0) - cnt
    ids = (torch.repeat_interleave(first - start, cnt, output_size=total)
           + torch.arange(total, device=lo.device))
    return int(torch.unique(ids).numel())


def dfa_bounds(live: int, walked: int, sectors: int, other: int) -> dict:
    """The DFA kernel's bounds over a column of ``live`` pool bytes whose
    walks must read ``walked`` of them, held in ``sectors`` 32-byte
    sectors, beside ``other`` bytes of offsets, validity and verdicts:
    ``bound_ms`` counts the walked bytes (what this run's data needs),
    ``bound_whole_ms`` every live byte, ``bound_sectors_ms`` the walked
    bytes' whole sectors."""
    return {"walked_bytes": walked, "walked_sectors": sectors,
            "bound_ms": bound_ms(walked + other),
            "bound_whole_ms": bound_ms(live + other),
            "bound_sectors_ms": bound_ms(32 * sectors + other)}


def dfa_uneven_phase(torch, np, dev, t, reps: int) -> None:
    """The DFA kernel over ``DFA_UNEVEN_ROWS`` rows of uneven lengths
    (uniform over ``DFA_UNEVEN_LENS`` bytes, slices of the text pool,
    seeded): every pattern held bit for bit to its plain version and
    timed beside its bounds."""
    from spark_rapids_tpu_torch.ops import regex as RX
    from spark_rapids_tpu_torch.ops import regex_kernels as RK

    rng = np.random.default_rng(26)
    n = DFA_UNEVEN_ROWS
    lens = rng.integers(DFA_UNEVEN_LENS[0], DFA_UNEVEN_LENS[1] + 1, n)
    start = rng.integers(0, t["pool"].size - DFA_UNEVEN_LENS[1], n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    chars = comment_chars(torch, {"pool": t["pool"], "lens": lens,
                                  "offsets": offsets, "start": start}, dev)
    off = torch.from_numpy(offsets.astype(np.int32)).to(dev)
    vld = torch.ones(n, dtype=torch.bool, device=dev)
    live = int(offsets[-1])
    for pat in (Q22D_REGEX,) + DFA_PATTERNS:
        d = RX.compile_search_dfa(pat)
        before = RK.LAUNCHES["dfa_accept_rows"]
        got = RK.dfa_accept_rows(off, chars, vld, d)
        want = RK.dfa_accept_rows_plain(off, chars, vld, d)
        if RK.LAUNCHES["dfa_accept_rows"] != before + 1 or not torch.equal(
                got, want):
            raise AssertionError(f"dfa_accept_rows {pat!r} on uneven rows: "
                                 f"{int((got != want).sum())} rows differ "
                                 "from the plain version")
        steps = torch.from_numpy(lens).to(dev)  # no stop state: every byte
        if RK.stop_states(d):
            steps, verdict = RK.dfa_exit_plain(off, chars, vld, d)
            if not torch.equal(verdict, want):
                raise AssertionError(f"dfa_exit_plain {pat!r} on uneven "
                                     "rows: verdicts differ")
        walked = int(steps.sum())
        sectors = walked_sectors(torch, off, steps)

        def run(d=d):
            return RK.dfa_accept_rows(off, chars, vld, d)

        emit({"kernel_shape": "dfa_accept_rows@uneven", "pattern": pat,
              "rows": n, "lens": list(DFA_UNEVEN_LENS),
              "live_bytes": live, "matches": int(got.sum()),
              "ms": cuda_ms(torch, run, reps),
              "dev_ms": dev_ms(torch, run, reps),
              **dfa_bounds(live, walked, sectors, 6 * n + 4)})


def dfa_kernel_phase(torch, np, dev, t, chars, reps: int) -> dict:
    """The DFA row matcher at Q22's shape: o_comment's 2^23 rows as one
    column (its offsets, its pool, every row valid). Each pattern's
    kernel is held to its plain version bit for bit over the whole
    column, its first 2^20 rows (the pool's later rows are garbage past
    the last offset) and a 2^16-row slice whose offsets start mid-pool;
    ``DFA_PATTERNS`` also run on a copy where every 5th row ends in
    '\\n', every 7th starts with 'é' and 3% are null. Each pattern also
    gives the bytes its walk must read (``walked_bytes``, from
    ``dfa_exit_plain``, whose verdicts must be the plain version's) and
    that bound, and the 32-byte sectors holding those bytes
    (:func:`walked_sectors`; device memory moves whole sectors) and their
    bound. Q22D_REGEX's times are the kernel's entry; Q22R_REGEX
    must be refused by the compiler, as the reference's. Then
    :func:`dfa_uneven_phase`."""
    from spark_rapids_tpu_torch.ops import regex as RX
    from spark_rapids_tpu_torch.ops import regex_kernels as RK

    n = t["n"]
    off = torch.from_numpy(t["offsets"].astype(np.int32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    var = chars.clone()
    var[off[1:][rows % 5 == 0].long() - 1] = 0x0A
    seven = off[:-1][rows % 7 == 0].long()
    var[seven] = 0xC3
    var[seven + 1] = 0xA9
    vvalid = torch.from_numpy(np.random.default_rng(24).random(n) > 0.03
                              ).to(dev)
    try:
        RX.compile_search_dfa(Q22R_REGEX)
        raise AssertionError(f"{Q22R_REGEX!r} compiled: the reference's "
                             "compiler refuses it")
    except RX.RegexUnsupported as e:
        emit({"kernel_shape": "dfa_accept_rows", "pattern": Q22R_REGEX,
              "refused": str(e)})
    mid = n // 2 + min(12345, n // 8)
    spans = ((0, n), (0, min(n, 1 << 20)), (mid, min(n, mid + (1 << 16))))
    live = int(t["offsets"][-1])
    nbytes = int(RK.dfa_accept_rows_bytes(off))
    out = None
    for pat, pool, vld in [(Q22D_REGEX, chars, valid)] + [
            (p, var, vvalid) for p in DFA_PATTERNS]:
        d = RX.compile_search_dfa(pat)
        for a, b in spans:
            o, v = off[a:b + 1], vld[a:b]
            got = RK.dfa_accept_rows(o, pool, v, d)
            want = RK.dfa_accept_rows_plain(o, pool, v, d)
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"dfa_accept_rows {pat!r} rows "
                                     f"[{a}, {b}): {bad} rows differ from "
                                     "the plain version")
            if (a, b) == (0, n):
                whole = want
        steps, verdict = RK.dfa_exit_plain(off, pool, vld, d)
        if not torch.equal(verdict, whole):
            raise AssertionError(f"dfa_exit_plain {pat!r}: verdicts differ "
                                 "from the plain version")
        walked = int(steps.sum())
        sectors = walked_sectors(torch, off, steps)
        matches = int(whole.sum())

        def run(pool=pool, vld=vld, d=d):
            return RK.dfa_accept_rows(off, pool, vld, d)

        res = {"ms": cuda_ms(torch, run, reps),
               "dev_ms": dev_ms(torch, run, reps),
               "host_ms": host_ms(torch, run, reps),
               "plain_ms": cuda_ms(torch, lambda: RK.dfa_accept_rows_plain(
                   off, pool, vld, d), max(1, reps // 10)),
               **dfa_bounds(live, walked, sectors, nbytes - live),
               "library_ms": None,
               "library": "none: no torch call computes a DFA",
               "max_abs_err": 0.0}
        if out is None:  # the kernels line's entry
            res["ptxas"] = dfa_ptxas()
        emit({"kernel_shape": "dfa_accept_rows", "pattern": pat, "rows": n,
              "bytes": nbytes, "states": d.nstates,
              "absorbing": d.absorbing,
              "stop_states": RK.stop_states(d), "matches": matches, **res})
        if out is None:
            out = res
    dfa_uneven_phase(torch, np, dev, t, reps)
    return out


def _orders_df(sess, opath, pred):
    from spark_rapids_tpu_torch.expr.expressions import col

    return (sess.read.parquet(opath, ["o_orderkey", "o_custkey",
                                      "o_comment"])
            .where(pred(col("o_comment"))).select("o_orderkey", "o_custkey"))


def tpch_q13_df(sess, opath, cpath, pred):
    """TPC-H Q13 (spec 2.4.13) as a port DataFrame: customer left outer
    join the orders whose comment passes ``pred``, count(o_orderkey) per
    customer, count(*) per c_count, by custdist DESC, c_count DESC. The
    join's extra condition on orders alone is the orders' filter, as
    Spark pushes it down."""
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col

    cust = sess.read.parquet(cpath, ["c_custkey"])
    return (cust.join(_orders_df(sess, opath, pred),
                      [("c_custkey", "o_custkey")], how="left")
            .group_by("c_custkey")
            .agg(A.agg(A.Count(col("o_orderkey")), "c_count"))
            .group_by("c_count").agg(A.agg(A.Count(None), "custdist"))
            .order_by("custdist", "c_count", ascending=False))


def _not_like(c):
    from spark_rapids_tpu_torch.expr import expressions as E

    return E.Not(E.Like(c, E.lit(Q22_LIKE)))


def _not_rlike(pattern):
    from spark_rapids_tpu_torch.expr import expressions as E

    return lambda c: E.Not(E.RLike(c, E.lit(pattern)))


def q22_queries(torch, np, dev, t, opath, cpath, like, anchored,
                profile: bool, opath_r: str) -> dict:
    """Q22 (TPC-H Q13 with its LIKE), Q22r (the same words as an RLIKE
    the DFA refuses: the planner runs that filter on the CPU engine, and
    the rows must be the LIKE's over the same orders) and Q22d (an RLIKE
    the DFA takes), through a port ``TpuSession`` over the parquet files,
    join strategy PALLAS (K4), aggregates AUTO; each against its numpy
    oracle. Q22r reads ``opath_r``, the orders' first row group (its
    CPU-engine filter is the longest step of the script). Returns each
    path's launches."""
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql import session as S

    n, nc = t["n"], t["customers"]
    nr = n // ORDERS_ROW_GROUPS
    want = q13_oracle(np, t, like)
    want_r = q13_oracle(np, {"customers": nc, "custkey": t["custkey"][:nr]},
                        like[:nr])
    want_d = q13_oracle(np, t, anchored)
    conf = {"spark.rapids.tpu.sql.join.strategy": "PALLAS"}
    per_query = {}
    for q, pred, rows_want, runs, orders in (
            ("Q22", _not_like, want, 4, opath),
            ("Q22r", _not_rlike(Q22R_REGEX), want_r, 1, opath_r),
            ("Q22d", _not_rlike(Q22D_REGEX), want_d, 4, opath)):
        n_q = nr if orders == opath_r else n
        in_bytes = (int(t["offsets"][n_q]) + n_q * (4 + 8 + 8 + 3)
                    + nc * 9)
        sess = S.TpuSession(conf, device=dev)
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        plans = []

        def run_once(sess=sess, pred=pred, orders=orders):
            rows = tpch_q13_df(sess, orders, cpath, pred).collect()
            plans.append(sess.last_executed_plan)
            return rows

        def check(rows, q=q, rows_want=rows_want):
            if rows != rows_want:
                raise AssertionError(f"{q}: {len(rows)} rows differ from "
                                     f"the numpy oracle's {len(rows_want)}")

        routes = decode_routes()
        cold, warm, counts = _walls(torch, q, run_once, check, runs)
        routes = query_routes(q, routes)
        cold_scans = [e.metrics["hostDecodeTime"].value / 1e6
                      for e in _device_tree(plans[0].tpu_child)
                      if isinstance(e, TpuFileSourceScanExec)]
        tree = plans[0].tree_string()
        text = tpch_q13_df(sess, orders, cpath, pred).explain()
        fallback = "CpuFilterExec" in tree
        dfa = counts["dfa_accept_rows"]
        if (counts["probe_ranges"] <= 0 or counts["bucket_sum"] <= 0
                or (q == "Q22d") != (dfa > 0) or fallback != (q == "Q22r")
                or (q == "Q22r" and "RLike: pattern not supported by the "
                    "byte DFA" not in text)):
            raise AssertionError(f"{q}: launches {counts}, plan {tree}")
        per_query[q] = counts
        scans = [{k: v.value for k, v in e.metrics.items()}
                 for e in _device_tree(plans[-1].tpu_child)
                 if isinstance(e, TpuFileSourceScanExec)]
        emit({"query": q, "orders": n_q, "customers": nc,
              "rows": len(rows_want), "last_run_scans": scans,
              "excluded_orders": int((like if q != "Q22d"
                                      else anchored)[:n_q].sum()),
              "cpu_filter": fallback, "cold_wall_ms": cold,
              "warm_wall_ms": warm, "cold_host_decode_ms": cold_scans,
              "decode_routes": routes, "bytes": in_bytes,
              "bound_ms": bound_ms(in_bytes), "launches": counts})
        if q == "Q22":
            emit({"host_decode": "Q22", **host_decode_timing(np, opath)})
        if profile and q != "Q22r":
            profile_plan(torch, q, lambda sess=sess, pred=pred: sess._execute(
                tpch_q13_df(sess, opath, cpath, pred).node).tpu_child,
                sess.conf, n, in_bytes, SORT_KERNELS)
    return per_query


def tpch_q22_rows(sess, opath, cpath):
    """TPC-H Q22 (spec 2.4.22) through a port session: the scalar
    subquery (avg(c_acctbal) over the chosen country codes with
    c_acctbal > 0) runs first and its value becomes the literal, as
    Spark's plan does; then customers of those codes above it with no
    orders (an anti join), count(*) and sum(c_acctbal) by country code.
    Returns (the average, the rows)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    def code():
        return E.Substring(col("c_phone"), lit(1), lit(2))

    def cust():
        return sess.read.parquet(cpath, ["c_custkey", "c_phone",
                                         "c_acctbal"])

    in_codes = E.In(code(), Q23_CODES)
    [(avg,)] = (cust().where(E.And(E.GreaterThan(
        col("c_acctbal"), E.Literal(0.0, T.DOUBLE)), in_codes))
        .agg(A.agg(A.Average(col("c_acctbal")), "avg")).collect())
    df = (cust().where(E.And(in_codes, E.GreaterThan(
        col("c_acctbal"), E.Literal(avg, T.DOUBLE))))
        .join(sess.read.parquet(opath, ["o_custkey"]),
              [("c_custkey", "o_custkey")], how="anti")
        .select(E.Alias(code(), "cntrycode"), col("c_acctbal"))
        .group_by("cntrycode")
        .agg(A.agg(A.Count(None), "numcust"),
             A.agg(A.Sum(col("c_acctbal")), "totacctbal"))
        .order_by("cntrycode"))
    return avg, df


def q23_tpch_q22(torch, np, dev, t, opath, cpath, profile: bool) -> dict:
    """Q23: TPC-H Q22 (:func:`tpch_q22_rows`) under AUTO with
    variableFloatAgg, against numpy: the average within 1e-12 of the
    sum of |x| over the count, counts exact, sums within 1e-12 of each
    group's sum of |x|."""
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql import session as S

    nc = t["customers"]
    codes = np.array([int(c) for c in Q23_CODES])
    cc, bal = t["nation"] + 10, t["acctbal"]
    sel = np.isin(cc, codes)
    pos = sel & (bal > 0)
    avg_want = bal[pos].sum() / pos.sum()
    has_orders = np.bincount(t["custkey"], minlength=nc + 1)[1:] > 0
    sess = S.TpuSession({"spark.rapids.tpu.sql.variableFloatAgg.enabled":
                         True}, device=dev)
    DeviceScanCache.reset()
    S._SCANNER_CACHE.clear()
    avgs = []

    def run_once():
        avg, df = tpch_q22_rows(sess, opath, cpath)
        avgs.append(avg)
        return df.collect()

    def check(rows):
        avg = avgs[-1]
        if not _close(avg, avg_want, np.abs(bal[pos]).sum() / pos.sum(),
                      1e-12):
            raise AssertionError(f"Q23: avg {avg} != {avg_want}")
        keep = sel & (bal > avg) & ~has_orders
        want = []
        for c in sorted(set(cc[keep].tolist())):
            g = keep & (cc == c)
            want.append((str(c), int(g.sum()), bal[g].sum(),
                         np.abs(bal[g]).sum()))
        if len(rows) != len(want) or any(
                r[:2] != w[:2] or not _close(r[2], w[2], w[3], 1e-12)
                for r, w in zip(rows, want)):
            raise AssertionError(f"Q23: rows {rows} != {want}")

    cold, warm, counts = _walls(torch, "Q23", run_once, check)
    # the string keys' sort path under AUTO (PALLAS): the RADIX kernel
    if not counts["radix_segment_reduce"] or counts["ordered_segment_sum"]:
        raise AssertionError(f"Q23: launches {counts}")
    in_bytes = nc * (8 + 15 + 4 + 8 + 3) + t["n"] * 9
    emit({"query": "Q23", "customers": nc, "orders": t["n"],
          "avg_acctbal": avgs[0], "cold_wall_ms": cold,
          "warm_wall_ms": warm, "bytes": in_bytes,
          "bound_ms": bound_ms(in_bytes), "launches": counts})
    if profile:
        profile_plan(torch, "Q23", lambda: sess._execute(tpch_q22_rows(
            sess, opath, cpath)[1].node).tpu_child, sess.conf, nc,
            in_bytes, SORT_KERNELS)
    return {"Q23": counts}


def price_planes(np, cents, valid):
    """Arrow planes of "D.CC" price strings (no leading zeros) for
    ``cents``, null rows empty."""
    dollars = cents // 100
    nd = np.where(dollars >= 100, 3, np.where(dollars >= 10, 2, 1))
    mat = np.zeros((cents.size, 6), np.uint8)
    for k in range(3):  # dollar digits, right-aligned in the first 3
        mat[:, 2 - k] = (dollars // 10 ** k) % 10 + ord("0")
    mat[:, 3] = ord(".")
    mat[:, 4] = (cents // 10) % 10 + ord("0")
    mat[:, 5] = cents % 10 + ord("0")
    keep = (np.arange(6)[None, :] >= 3 - nd[:, None]) & valid[:, None]
    lens = keep.sum(1)
    off = np.zeros(cents.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off, mat[keep]


def _py_initcap(s):
    out, up = [], True
    for ch in s.lower():
        out.append(ch.upper() if up else ch)
        up = ch == " "
    return "".join(out)


def _py_pad(s, n, p, left):
    if len(s) >= n:
        return s[:n]
    fill = (p * n)[:n - len(s)]
    return fill + s if left else s + fill


def _py_substring_index(s, d, k):
    parts = s.split(d)
    return d.join(parts[:k] if k > 0 else parts[k:])


def _py_split_part(s, d, k):
    parts = s.split(d)
    return parts[k] if k < len(parts) else None


def _nn(f):
    """``f`` over non-null inputs; NULL in, NULL out."""
    return lambda *a: None if any(x is None for x in a) else f(*a)


def q24_projections():
    """(name, build(col, lit, E, T), Python function of the row dict) of
    Q24's item projection: each function on the plain i_item_id or
    i_price and on the dictionaries i_brand, i_category or i_wholesale."""
    import re

    return [
        ("initcap_dict", lambda c, l, E, T: E.InitCap(c("i_brand")),
         lambda r: _nn(_py_initcap)(r["i_brand"])),
        ("initcap_plain", lambda c, l, E, T: E.InitCap(c("i_item_id")),
         lambda r: _nn(_py_initcap)(r["i_item_id"])),
        ("locate_dict", lambda c, l, E, T: E.StringLocate(
            l("an"), c("i_brand"), l(1)),
         lambda r: _nn(lambda s: s.find("an") + 1)(r["i_brand"])),
        ("locate_plain", lambda c, l, E, T: E.StringLocate(
            l("B"), c("i_item_id"), l(10)),
         lambda r: _nn(lambda s: s.find("B", 9) + 1)(r["i_item_id"])),
        ("replace_dict", lambda c, l, E, T: E.StringReplace(
            c("i_brand"), l("a"), l("AA")),
         lambda r: _nn(lambda s: s.replace("a", "AA"))(r["i_brand"])),
        ("replace_plain", lambda c, l, E, T: E.StringReplace(
            c("i_item_id"), l("AB"), l("x")),
         lambda r: _nn(lambda s: s.replace("AB", "x"))(r["i_item_id"])),
        ("regexp_replace_dict", lambda c, l, E, T: E.RegExpReplace(
            c("i_brand"), l(" #"), l("-")),
         lambda r: _nn(lambda s: s.replace(" #", "-"))(r["i_brand"])),
        ("regexp_replace_plain", lambda c, l, E, T: E.RegExpReplace(
            c("i_price"), l("\\."), l(",")),
         lambda r: _nn(lambda s: s.replace(".", ","))(r["i_price"])),
        ("lpad_dict", lambda c, l, E, T: E.StringLPad(
            c("i_brand"), l(20), l("*")),
         lambda r: _nn(lambda s: _py_pad(s, 20, "*", True))(r["i_brand"])),
        ("lpad_plain", lambda c, l, E, T: E.StringLPad(
            c("i_price"), l(8), l("0")),
         lambda r: _nn(lambda s: _py_pad(s, 8, "0", True))(r["i_price"])),
        ("rpad_plain", lambda c, l, E, T: E.StringRPad(
            c("i_item_id"), l(20), l(".-")),
         lambda r: _nn(lambda s: _py_pad(s, 20, ".-", False))(
             r["i_item_id"])),
        ("rpad_dict", lambda c, l, E, T: E.StringRPad(
            c("i_category"), l(12), l("_")),
         lambda r: _nn(lambda s: _py_pad(s, 12, "_", False))(
             r["i_category"])),
        ("substring_index_dict", lambda c, l, E, T: E.SubstringIndex(
            c("i_brand"), l(" "), l(1)),
         lambda r: _nn(lambda s: _py_substring_index(s, " ", 1))(
             r["i_brand"])),
        ("substring_index_plain", lambda c, l, E, T: E.SubstringIndex(
            c("i_price"), l("."), l(-1)),
         lambda r: _nn(lambda s: _py_substring_index(s, ".", -1))(
             r["i_price"])),
        ("split_part_dict", lambda c, l, E, T: E.StringSplitPart(
            c("i_brand"), l("#"), l(1)),
         lambda r: _nn(lambda s: _py_split_part(s, "#", 1))(r["i_brand"])),
        ("split_part_plain", lambda c, l, E, T: E.StringSplitPart(
            c("i_price"), l("."), l(0)),
         lambda r: _nn(lambda s: _py_split_part(s, ".", 0))(r["i_price"])),
        ("like_dict", lambda c, l, E, T: E.Like(c("i_category"), l("_ome")),
         lambda r: _nn(lambda s: re.fullmatch(".ome", s) is not None)(
             r["i_category"])),
        ("like_plain", lambda c, l, E, T: E.Like(
            c("i_item_id"), l("AAAAAAAA_A______")),
         lambda r: _nn(lambda s: re.fullmatch("AAAAAAAA.A......", s)
                       is not None)(r["i_item_id"])),
        ("in_dict", lambda c, l, E, T: E.In(
            c("i_category"), ("Books", "Home", "Music")),
         lambda r: _nn(lambda s: s in ("Books", "Home", "Music"))(
             r["i_category"])),
        ("in_plain", lambda c, l, E, T: E.In(
            c("i_price"), ("1.00", "12.50", "999.99")),
         lambda r: _nn(lambda s: s in ("1.00", "12.50", "999.99"))(
             r["i_price"])),
        ("cast_dict_to_bigint", lambda c, l, E, T: E.Cast(
            E.StringSplitPart(c("i_brand"), l("#"), l(1)), T.LONG),
         lambda r: r["i_brand_id"]),
        ("cast_plain_to_double", lambda c, l, E, T: E.Cast(
            c("i_price"), T.DOUBLE),
         lambda r: _nn(float)(r["i_price"])),
        ("cast_dict_to_double", lambda c, l, E, T: E.Cast(
            c("i_wholesale"), T.DOUBLE),
         lambda r: _nn(float)(r["i_wholesale"])),
        ("coalesce", lambda c, l, E, T: E.Coalesce(
            (c("i_price"), c("i_category"))),
         lambda r: r["i_price"] if r["i_price"] is not None
         else r["i_category"]),
        ("case_when", lambda c, l, E, T: E.CaseWhen(
            ((E.Contains(c("i_category"), l("o")), c("i_brand")),
             (E.IsNull(c("i_price")), c("i_item_id"))), c("i_price")),
         lambda r: r["i_brand"] if "o" in r["i_category"]
         else (r["i_item_id"] if r["i_price"] is None else r["i_price"])),
    ]


def dict_item_col(np, dev, codes, entries, n: int, cap: int):
    """A dictionary-encoded column of ``n`` rows (capacity ``cap``) whose
    row i holds ``entries[codes[i]]``; ``unique`` set."""
    from spark_rapids_tpu_torch.columnar import (choose_capacity,
                                                 dict_column_from_parts)

    lens = np.array([len(e) for e in entries], np.int64)
    doff = np.zeros(len(entries) + 1, np.int32)
    np.cumsum(lens, out=doff[1:])
    c = np.zeros(cap, np.int32)
    c[:n] = codes
    return dict_column_from_parts(
        n, c, doff, np.frombuffer(b"".join(entries), np.uint8),
        np.arange(cap) < n,
        mat_cap=choose_capacity(int(lens[codes].sum()), 128),
        max_len=int(lens.max()), unique=True, device=dev)


def _plain_col(np, dev, planes, valid, cap: int):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import DeviceColumn

    off, chars = planes
    n = off.size - 1
    full = np.full(cap + 1, off[-1], np.int64)
    full[:n + 1] = off
    v = np.zeros(cap, bool)
    v[:n] = valid
    return DeviceColumn.from_string_arrays(T.STRING, n, full, chars, v, dev)


def _sample_rows(torch, batch, idx):
    """The batch's rows at ``idx`` on the host, one list per column."""
    from spark_rapids_tpu_torch.exec.base import batch_from_vals, vals_of_batch
    from spark_rapids_tpu_torch.ops import filter_gather

    m = idx.numel()
    g = filter_gather.gather(vals_of_batch(batch), idx,
                             torch.ones(m, dtype=torch.bool,
                                        device=idx.device))
    sb = batch_from_vals(g, batch.schema, m)
    return [c.to_host().to_pylist() for c in sb.columns]


def q24_string_functions(torch, np, dev, t, log2_rows: int,
                         profile: bool) -> dict:
    """Q24: the item-15 string functions as one projection over Q19's
    item table (2^23 rows; i_item_id and i_price plain, i_category,
    i_brand and i_wholesale dictionaries; :func:`q24_projections`), and
    Q24c: cast(c_custkey as string), its cast back to bigint and
    cast(substring(c_phone, 1, 2) as int) over Q22's customers. Q24's
    outputs are held row for row to Python's own string functions on a
    seeded 2^16-row sample (floats within 1e-12: the reference's parse is
    not correctly rounded), and its row count in full; Q24c's casts in
    full (the round trip gives c_custkey, the code nationkey + 10)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import (ColumnarBatch, DeviceColumn,
                                                 HostColumn, choose_capacity,
                                                 schema_of)
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import InMemoryScanExec, TpuProjectExec
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    n = 1 << log2_rows
    it = item_table(np, n)
    cap = choose_capacity(n)
    rng = np.random.default_rng(26)
    cents = rng.integers(0, 100_000, n)
    pvalid = rng.random(n) > 0.05
    wcents = np.unique(rng.integers(0, 100_000, 500))
    woff, wchars = price_planes(np, wcents, np.ones(wcents.size, bool))
    wentries = sorted(wchars[woff[i]:woff[i + 1]].tobytes()
                      for i in range(wcents.size))
    wcodes = rng.integers(0, len(wentries), n)
    names = [brand_name(i) for i in range(1, 1001)]
    ones = np.ones(n, bool)
    schema = schema_of(i_item_id=T.STRING, i_category=T.STRING,
                       i_brand=T.STRING, i_brand_id=T.INT,
                       i_price=T.STRING, i_wholesale=T.STRING)
    batch = ColumnarBatch([
        _plain_col(np, dev, item_id_planes(np, it["id"]), ones, cap),
        dict_item_col(np, dev, it["cat"], list(CATEGORIES), n, cap),
        dict_item_col(np, dev, it["brand"] - 1, names, n, cap),
        DeviceColumn.from_host(HostColumn(T.INT, it["brand"], ones), cap,
                               "i_brand_id", dev),
        _plain_col(np, dev, price_planes(np, cents, pvalid), pvalid, cap),
        dict_item_col(np, dev, wcodes, wentries, n, cap)], schema, n)
    conf = RapidsConf({})
    projs = q24_projections()
    exprs = [E.Alias(build(col, lit, E, T), name)
             for name, build, _ in projs]
    in_bytes = n * (16 + 5 + 5 + 4 + 1 + 5 + 5 + 5) + int(pvalid.sum()) * 6

    def scan():
        return InMemoryScanExec(conf, [[batch]], schema)

    outs = []

    def run_once():
        out = list(TpuProjectExec(conf, exprs, scan()).execute_partition(0))
        outs[:] = out
        return sum(int(b.num_rows) for b in out)

    def check(rows):
        if rows != n:
            raise AssertionError(f"Q24: {rows} rows, expected {n}")

    per_query = {}
    cold, warm, counts = _walls(torch, "Q24", run_once, check)
    if any(counts.values()):
        raise AssertionError(f"Q24 launched {counts}")
    idx = np.sort(rng.choice(n, min(n, 1 << 16), replace=False))
    got = _sample_rows(torch, outs[0], torch.from_numpy(idx).to(dev))
    for i, k in enumerate(idx.tolist()):
        row = {"i_item_id": item_id(int(it["id"][k])),
               "i_category": CATEGORIES[it["cat"][k]].decode(),
               "i_brand": names[it["brand"][k] - 1].decode(),
               "i_brand_id": int(it["brand"][k]),
               "i_price": (None if not pvalid[k] else
                           f"{cents[k] // 100}.{cents[k] % 100:02d}"),
               "i_wholesale": wentries[wcodes[k]].decode()}
        for (name, _, fn), column in zip(projs, got):
            want, g = fn(row), column[i]
            if isinstance(want, float) and g is not None:
                ok = abs(g - want) <= 1e-12 * abs(want)
            else:
                ok = g == want
            if not ok:
                raise AssertionError(f"Q24 {name} row {k}: {g!r} != "
                                     f"{want!r} ({row})")
    del outs[:]
    per_query["Q24"] = counts
    emit({"query": "Q24", "rows": n, "functions": [p[0] for p in projs],
          "sample_rows": int(idx.size), "cold_wall_ms": cold,
          "warm_wall_ms": warm, "bytes": in_bytes,
          "bound_ms": bound_ms(in_bytes), "launches": counts})
    if profile:
        profile_run(torch, "Q24", lambda: _timed(torch, run_once), n,
                    in_bytes)
        del outs[:]

    # Q24c: the integer casts over the customers
    nc = t["customers"]
    ccap = choose_capacity(nc)
    cschema = schema_of(c_custkey=T.LONG, c_phone=T.STRING)
    cbatch = ColumnarBatch([
        DeviceColumn.from_host(HostColumn(T.LONG, t["c_custkey"],
                                          np.ones(nc, bool)), ccap,
                               "c_custkey", dev),
        _plain_col(np, dev, t["phone"], np.ones(nc, bool), ccap)],
        cschema, nc)
    key_str = E.Cast(col("c_custkey"), T.STRING)
    cexprs = [E.Alias(key_str, "k_str"),
              E.Alias(E.Cast(key_str, T.LONG), "k_back"),
              E.Alias(E.Cast(E.Substring(col("c_phone"), lit(1), lit(2)),
                             T.INT), "cc")]
    want_k = torch.from_numpy(t["c_custkey"]).to(dev)
    want_cc = torch.from_numpy(t["nation"] + 10).to(dev)

    def run_c():
        [b] = list(TpuProjectExec(conf, cexprs, InMemoryScanExec(
            conf, [[cbatch]], cschema)).execute_partition(0))
        outs[:] = [b]
        return b

    def check_c(b):
        k, c = b.columns[1], b.columns[2]
        if not (torch.equal(k.data[:nc], want_k)
                and torch.equal(c.data[:nc], want_cc)
                and bool(k.validity[:nc].all()) and bool(
                    c.validity[:nc].all())):
            raise AssertionError("Q24c: the casts differ from c_custkey "
                                 "and nationkey + 10")

    cold, warm, counts = _walls(torch, "Q24c", run_c, check_c)
    cidx = np.sort(rng.choice(nc, min(nc, 1 << 16), replace=False))
    [ks, _, _] = _sample_rows(torch, outs[0], torch.from_numpy(cidx).to(dev))
    if ks != [str(int(t["c_custkey"][k])) for k in cidx]:
        raise AssertionError("Q24c: cast(c_custkey as string) differs")
    del outs[:]
    if any(counts.values()):
        raise AssertionError(f"Q24c launched {counts}")
    per_query["Q24c"] = counts
    emit({"query": "Q24c", "rows": nc, "cold_wall_ms": cold,
          "warm_wall_ms": warm, "bytes": nc * 24,
          "bound_ms": bound_ms(nc * 24), "launches": counts})
    if profile:
        profile_run(torch, "Q24c", lambda: _timed(torch, run_c), nc,
                    nc * 24)
        del outs[:]
    return per_query


def string_expr_phase(torch, np, dev, log2_rows: int, reps: int,
                      profile: bool = False):
    """The DFA kernel and Q22-Q24 at ``log2_rows`` orders: TPC-H's orders
    and customers written by pyarrow with its defaults under
    ``_chip_data/`` (removed after), then :func:`dfa_kernel_phase`,
    :func:`q22_queries`, :func:`q23_tpch_q22` and
    :func:`q24_string_functions`. Returns each path's launches and the
    DFA kernel's numbers, keyed as ``kernels_line`` reads them."""
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    n = 1 << log2_rows
    t = tpch_orders_customers(np, n)
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, PARQUET_DIR)
    opath = os.path.join(base, "orders")
    opath_r = os.path.join(base, "orders_r")
    cpath = os.path.join(base, "customer")
    shutil.rmtree(base, ignore_errors=True)
    for d in (opath, opath_r, cpath):
        os.makedirs(d)
    try:
        chars = comment_chars(torch, t, dev)
        t0 = time.perf_counter()
        orders = pa.table({
            "o_orderkey": t["orderkey"], "o_custkey": t["custkey"],
            "o_comment": _pa_strings(pa, np, (t["offsets"],
                                              chars.cpu().numpy()))})
        nr = n // ORDERS_ROW_GROUPS
        pq.write_table(orders, os.path.join(opath, "t.parquet"),
                       row_group_size=nr)  # pyarrow's defaults
        pq.write_table(orders.slice(0, nr),
                       os.path.join(opath_r, "t.parquet"))
        del orders
        pq.write_table(pa.table({
            "c_custkey": t["c_custkey"], "c_nationkey": t["nation"],
            "c_phone": _pa_strings(pa, np, t["phone"]),
            "c_acctbal": t["acctbal"]}), os.path.join(cpath, "t.parquet"))
        write_s = time.perf_counter() - t0
        like, anchored = like_oracle(np, t), anchored_oracle(np, t)
        check_text_oracles(np, t, like, anchored)
        emit({"tables": "orders, customer", "orders": n,
              "customers": t["customers"], "file_write_s": write_s,
              "comment_bytes": int(t["offsets"][-1]),
              "like_match_share": float(like.mean()),
              "dfa_match_share": float(anchored.mean())})
        dfa = dfa_kernel_phase(torch, np, dev, t, chars, reps)
        del chars
        per_query = q22_queries(torch, np, dev, t, opath, cpath, like,
                                anchored, profile, opath_r)
        per_query.update(q23_tpch_q22(torch, np, dev, t, opath, cpath,
                                      profile))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    per_query.update(q24_string_functions(torch, np, dev, t, log2_rows,
                                          profile))
    return per_query, {("dfa_accept_rows", 128): dfa}


# ---------------------------------------------------------------------------
# exchange phase (Q11m, Q20m, Q22m, Q18m, Q14m): multi-file tables
# ---------------------------------------------------------------------------
#: Q11m's table is written as this many files (one row group each)
Q11M_FILES = 8
#: Q20m's, Q22m's orders, Q18m's fact and Q14m's tables: this many files
MULTI_FILES = 4


def _write_files(pa, pq, path: str, table, files: int, **kw) -> float:
    """``table`` as ``files`` parquet files of one row group each under
    ``path`` (pyarrow's other defaults, unless ``kw`` sets them:
    dictionary pages, snappy); returns the seconds taken."""
    t0 = time.perf_counter()
    os.makedirs(path)
    per = -(-table.num_rows // files)
    for i in range(files):
        pq.write_table(table.slice(i * per, per),
                       os.path.join(path, f"part-{i}.parquet"),
                       row_group_size=per, **kw)
    return time.perf_counter() - t0


def _pa_nullable_strings(pa, np, planes, valid):
    """An Arrow string array of (offsets, chars) planes whose rows are
    null where ``valid`` is false."""
    off, chars = planes
    return pa.Array.from_buffers(
        pa.string(), off.size - 1,
        [pa.py_buffer(np.packbits(valid, bitorder="little")),
         pa.py_buffer(off.astype(np.int32)), pa.py_buffer(chars)])


def exchange_report(plan) -> list:
    """Each exchange of a device plan with its metrics."""
    from spark_rapids_tpu_torch.exec.exchange import (
        TpuBroadcastExchangeExec, TpuShuffleExchangeExec)

    out = []
    for e in _device_tree(plan):
        if isinstance(e, (TpuShuffleExchangeExec, TpuBroadcastExchangeExec)):
            out.append({"exec": e.describe(), **{
                k: e.metrics[k].value for k in (
                    "partitionSize", "dataSize", "shuffleBytesWritten",
                    "shuffleBytesFetched", "codecEncodeTime",
                    "codecDecodeTime", "totalTime") if k in e.metrics}})
    return out


def exchange_query(torch, q: str, sess, df_of, check, need: str, rows: int,
                   nbytes: int, expect=lambda counts: True) -> dict:
    """One query of the exchange phase through the session: a cold and
    three warm walls (the launch counts set to 0 before each run and read
    after, every run repeating the first's), ``expect(counts)`` asserted,
    ``explain_metrics()`` required to name the exchange ``need``, the
    exchanges' metrics, and a profiled run (busy time, idle share).
    Returns the launches."""
    plans = []
    mem = []

    def run_once():
        rows_ = df_of().collect()
        plans[:] = [sess.last_executed_plan]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
        return rows_

    cold, warm, counts = _walls(torch, q, run_once, check)
    text = sess.explain_metrics()
    if need not in text or not expect(counts):
        raise AssertionError(f"{q}: launches {counts}, plan\n{text}")
    # the exchanges release their pieces after the last reduce partition:
    # the warm runs leave the same memory behind (the scan cache's and the
    # last plan's)
    if mem and max(mem[1:]) - min(mem[1:]) > 16 << 20:
        raise AssertionError(f"{q}: device memory grew between warm runs: "
                             f"{mem}")
    emit({"query": q, "rows": rows, "cold_wall_ms": cold,
          "warm_wall_ms": warm, "bytes": nbytes,
          "bound_ms": bound_ms(nbytes), "launches": counts,
          "exchanges": exchange_report(plans[-1].tpu_child),
          "memory_allocated_after_each_run": mem,
          "plan": text.splitlines()})
    profile_run(torch, q, lambda: _timed(torch, lambda: df_of().collect()),
                rows, nbytes, SORT_KERNELS, unprofiled=0)
    return counts


def q18m_write(np, pa, pq, base: str):
    """Q18m's tables under ``base``: Q18's fact of 2^STRING_LOG2_ROWS rows
    as :data:`MULTI_FILES` files, its dim as one. Returns (fact path, dim
    path, oracle rows, seconds spent writing)."""
    n = 1 << STRING_LOG2_ROWS
    z = zip_tables(np, n, DIM_ROWS)
    cities = city_pool(np)
    want18 = q18_oracle(np, z, cities, DIM_ROWS)
    zips = zip_pool(DIM_ROWS)
    fpath = os.path.join(base, "fact")
    dpath = os.path.join(base, "dim")
    write_s = _write_files(pa, pq, fpath, pa.table({
        "zip": _pa_nullable_strings(
            pa, np, pool_planes(np, z["fzip"], zips, ~z["fnull"]),
            ~z["fnull"]),
        "net_paid": z["paid"]}), MULTI_FILES)
    write_s += _write_files(pa, pq, dpath, pa.table({
        "dzip": _pa_strings(pa, np, pool_planes(np, z["dzip"], zips)),
        "city": _pa_strings(pa, np, pool_planes(np, z["dcity"], cities)),
        "state": _pa_strings(pa, np, pool_planes(np, z["dstate"],
                                                 STATES))}), 1)
    return fpath, dpath, want18, write_s


def q18m_df(sess, fpath: str, dpath: str):
    """Q18m: the fact files join the dim on zip, group by city: count,
    sum(net_paid), min(state), max(state)."""
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col

    return (sess.read.parquet(fpath)
            .join(sess.read.parquet(dpath), [("zip", "dzip")])
            .group_by("city")
            .agg(A.agg(A.Count(None), "n"),
                 A.agg(A.Sum(col("net_paid")), "s"),
                 A.agg(A.Min(col("state")), "mn"),
                 A.agg(A.Max(col("state")), "mx")))


def q18m_check(want18, rows, what: str) -> None:
    """Q18m's rows against :func:`q18_oracle`'s: cities, counts and
    states exactly, sums within 1e-12 of each city's sum of |x|."""
    rows = sorted(rows)
    if len(rows) != len(want18):
        raise AssertionError(f"{what}: {len(rows)} cities")
    for r, (c, k, s_, mag, mn, mx) in zip(rows, want18):
        if (r[0], r[1], r[3], r[4]) != (c, k, mn, mx) or not _close(
                r[2], s_, mag, 1e-12):
            raise AssertionError(f"{what}: {r} != {(c, k, s_, mn, mx)}")


def exchange_phase(torch, np, dev) -> dict:
    """Q11m, Q20m (and Q20ms), Q22m, Q18m and Q14m: earlier tables written
    as several parquet files (several splits, so several partitions)
    under ``_chip_data/`` (removed after) and driven through the port
    session, so that their aggregates, sorts, joins and windows run
    through the exchanges (``exec/exchange.py``); each against its
    oracle, with :func:`exchange_query`'s walls, launch checks, plan,
    exchange metrics and profile. Q11m also runs under
    ``shuffle.transport.class=host`` (Q11mh: the serializer on the path)
    and checks that device memory does not grow from run to run (the
    pieces are released). Returns each path's launches."""
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr import windows as W
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql import session as S

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, PARQUET_DIR)
    shutil.rmtree(base, ignore_errors=True)
    per_query = {}
    vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}

    def fresh(settings):
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        return S.TpuSession(settings, device=dev)

    try:
        # --- Q11m: Q11's table as 8 files -----------------------------------
        n = 1 << PARQUET_LOG2_ROWS
        item, qty, cost, date = bench_parquet_table(np, n)
        path = os.path.join(base, "store_sales")
        write_s = _write_files(pa, pq, path, pa.table({
            "ss_item_sk": item, "ss_quantity": qty,
            "ss_wholesale_cost": cost, "ss_sold_date_sk": date}), Q11M_FILES)
        emit({"table": "store_sales", "files": Q11M_FILES, "rows": n,
              "write_s": write_s})
        check11 = q11_check(np, qty, cost, date)
        # Q11mo: Q11m with both fusions off (each file's decoded batches
        # through the scan cache, the streaming updates and merges). On
        # the card AUTO fuses each file's partial stage and the final
        # side's plan; Q11mo streams every partition
        fused = {"stage": Q11M_FILES, "plan": 1}
        for q, transport, codec, extra, want_route in (
                ("Q11m", "device", "none", {}, fused),
                ("Q11mo", "device", "none", FUSION_OFF,
                 {"update": Q11M_FILES + 1}),
                ("Q11mh", "host", "none", {}, fused),
                ("Q11mz", "host", "lz4", {}, fused)):
            sess = fresh({**vfa, "spark.rapids.tpu.shuffle.transport.class":
                          transport,
                          "spark.rapids.tpu.shuffle.compression.codec":
                          codec, **extra})

            def q11(sess=sess):
                return (sess.read.parquet(path)
                        .where(E.GreaterThanOrEqual(col("ss_sold_date_sk"),
                                                    lit(2_452_015)))
                        .group_by("ss_quantity")
                        .agg(A.agg(A.Sum(col("ss_wholesale_cost")), "s"),
                             A.agg(A.Count(col("ss_item_sk")), "c")))

            # K1 and K2 in both halves: each file's partial, and the final
            per_query[q] = exchange_query(
                torch, q, sess, q11, lambda rows, q=q: check11(rows, q),
                "TpuShuffleExchangeExec HashPartitioning", n, n * 20,
                lambda c, want_route=want_route: all(
                    c[k] > Q11M_FILES for k in ("bucket_sum",
                                                "bucket_float_sum"))
                and (dev.type != "cuda" or c.agg_route == want_route))
        shutil.rmtree(path)

        # --- Q20m: TPC-H Q1 over lineitem as 4 dictionary-encoded files -----
        n = 1 << STRING_LOG2_ROWS
        t, want, kept, strs = lineitem_inputs(np, n)
        path = os.path.join(base, "lineitem")
        write_s = _write_files(pa, pq, path, pa.table({
            **{k: _pa_strings(pa, np, v) for k, v in strs.items()},
            "l_quantity": t["qty"], "l_extendedprice": t["price"],
            "l_discount": t["disc"], "l_tax": t["tax"],
            "l_shipdate": t["ship"]}), MULTI_FILES)
        emit({"table": "lineitem", "files": MULTI_FILES, "rows": n,
              "write_s": write_s})
        for q, strategy in (("Q20m", "AUTO"), ("Q20ms", "SCATTER")):
            sess = fresh({**vfa, "spark.rapids.tpu.sql.agg.strategy":
                          strategy})
            kernels = ("bucket_sum", "bucket_float_sum")

            def expect(c, strategy=strategy):
                if strategy == "AUTO":
                    return all(c[k] >= MULTI_FILES for k in kernels)
                return (not any(c[k] for k in kernels)
                        and c["ordered_segment_sum"] > 0)

            per_query[q] = exchange_query(
                torch, q, sess, lambda sess=sess: tpch_q1_df(np, sess, path),
                lambda rows, q=q: tpch_q1_check(want, rows, q),
                "TpuShuffleExchangeExec RangePartitioning", n,
                n * (4 * 8 + 4) + 3 * 5 * n, expect)
        q28_queries(torch, np, fresh(vfa), path, t, strs, per_query)
        shutil.rmtree(path)

        # --- Q22m: TPC-H Q13 over orders (4 files) and customer (2 files) ---
        n = 1 << ORDERS_LOG2_ROWS
        t = tpch_orders_customers(np, n)
        chars = comment_chars(torch, t, dev).cpu().numpy()
        opath = os.path.join(base, "orders")
        cpath = os.path.join(base, "customer")
        write_s = _write_files(pa, pq, opath, pa.table({
            "o_orderkey": t["orderkey"], "o_custkey": t["custkey"],
            "o_comment": _pa_strings(pa, np, (t["offsets"], chars))}),
            MULTI_FILES)
        write_s += _write_files(pa, pq, cpath, pa.table({
            "c_custkey": t["c_custkey"]}), 2)
        del chars
        want22 = q13_oracle(np, t, like_oracle(np, t))
        emit({"table": "orders, customer", "files": [MULTI_FILES, 2],
              "orders": n, "customers": t["customers"], "write_s": write_s})
        sess = fresh({"spark.rapids.tpu.sql.join.strategy": "PALLAS"})

        def check22(rows):
            if rows != want22:
                raise AssertionError("Q22m: rows differ from the numpy "
                                     "oracle")

        per_query["Q22m"] = exchange_query(
            torch, "Q22m", sess,
            lambda: tpch_q13_df(sess, opath, cpath, _not_like), check22,
            "TpuLazyAQEReadExec -> TpuAQEShuffleReadExec", n,
            int(t["offsets"][-1]) + n * 20 + t["customers"] * 8,
            lambda c: c["probe_ranges"] > 0 and c["bucket_sum"] > 0)
        shutil.rmtree(opath)
        shutil.rmtree(cpath)

        # --- Q18m: Q18's zip join, the dim broadcast ------------------------
        n = 1 << STRING_LOG2_ROWS
        fpath, dpath, want18, write_s = q18m_write(np, pa, pq, base)
        emit({"table": "fact, dim", "files": [MULTI_FILES, 1],
              "fact_rows": n, "dim_rows": DIM_ROWS, "write_s": write_s,
              "dim_bytes": sum(os.path.getsize(os.path.join(dpath, f))
                               for f in os.listdir(dpath))})
        sess = fresh({**vfa, "spark.rapids.tpu.sql.join.strategy": "PALLAS"})

        def q18():
            return q18m_df(sess, fpath, dpath)

        def check18(rows):
            q18m_check(want18, rows, "Q18m")

        per_query["Q18m"] = exchange_query(
            torch, "Q18m", sess, q18, check18, "TpuBroadcastExchangeExec", n,
            n * 19 + DIM_ROWS * 30,
            lambda c: c["probe_ranges"] == MULTI_FILES)
        shutil.rmtree(fpath)
        shutil.rmtree(dpath)

        # --- Q14m: bench.py shape_window over 4 files -----------------------
        n = 1 << SORT_LOG2_ROWS
        rng = np.random.default_rng(13)
        k = rng.integers(0, 64, n).astype(np.int32)
        ts = rng.permutation(n).astype(np.int64)
        v = rng.integers(0, 1000, n).astype(np.int64)
        order = np.lexsort((ts, k))
        want14 = []
        for g in range(64):
            rows = order[k[order] == g][:3]
            rs = np.cumsum(v[rows])
            want14 += [(g, int(ts[r]), int(v[r]), int(s_), i + 1)
                       for i, (r, s_) in enumerate(zip(rows, rs))]
        path = os.path.join(base, "window")
        write_s = _write_files(pa, pq, path, pa.table({"k": k, "ts": ts,
                                                       "v": v}), MULTI_FILES)
        emit({"table": "window", "files": MULTI_FILES, "rows": n,
              "write_s": write_s})
        sess = fresh({})
        spec = W.WindowSpec(partition_by=(col("k"),), order_by=(col("ts"),),
                            orders=((True, True),))

        def q14():
            return (sess.read.parquet(path)
                    .with_windows(W.WindowExpression(A.Sum(col("v")), spec,
                                                     "rs"),
                                  W.WindowExpression(W.RowNumber(), spec,
                                                     "rn"))
                    .where(E.LessThanOrEqual(col("rn"), lit(3))))

        def check14(rows):
            if rows != want14:
                raise AssertionError("Q14m: rows differ from the numpy "
                                     "oracle")

        per_query["Q14m"] = exchange_query(
            torch, "Q14m", sess, q14, check14, "TpuWindowExec", n, n * 20,
            lambda c: not any(c.values()))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return per_query


# ---------------------------------------------------------------------------
# decimal and date phase (Q25-Q27): TPC-DS store_sales with its spec types
# ---------------------------------------------------------------------------
#: store_sales rows of Q25-Q27, as a power of two (TPC-DS SF 1 has
#: 2 880 404)
SALES_LOG2_ROWS = 23
#: d_date_sk of the first date_dim row (1900-01-02) and the row count
DATE_DIM_FIRST_SK = 2_415_022
DATE_DIM_ROWS = 73_049
#: d_date_sk - JULIAN_EPOCH = days since 1970-01-01 (a Julian day number)
JULIAN_EPOCH = 2_440_588
#: the d_date_sk range dsdgen draws store_sales' sold dates from
SALES_FIRST_SK, SALES_LAST_SK = 2_450_816, 2_452_642
STORES = 12
US_PER_DAY = 86_400_000_000
#: q5's first day and its width (date_add(cast('2000-08-23' as date), 14))
Q25_FIRST = "2000-08-23"
Q25_DAYS = 14


def store_sales_table(np, n: int) -> dict:
    """TPC-DS store_sales rows (``rng(25)``): row ids (ss_ticket_number),
    sold-date keys (4% NULL), stores, quantities and the two decimal(7,2)
    amounts in cents from dsdgen's pricing (wholesale 1.00-100.00, a
    markup of 0-200%, a discount of 0-100%; profit = ext sales price -
    ext wholesale cost; 2% NULL each), the sold date in days and a sold
    timestamp in microseconds (NULL with the date key)."""
    rng = np.random.default_rng(25)
    sk = rng.integers(SALES_FIRST_SK, SALES_LAST_SK + 1, n).astype(np.int32)
    dvalid = rng.random(n) >= 0.04
    store = rng.integers(1, STORES + 1, n).astype(np.int32)
    qty = rng.integers(1, 101, n).astype(np.int32)
    wholesale = rng.integers(100, 10_001, n)
    listed = wholesale * (100 + rng.integers(0, 201, n)) // 100
    sold = listed * (100 - rng.integers(0, 101, n)) // 100
    price = sold * qty
    profit = price - wholesale * qty
    days = sk.astype(np.int64) - JULIAN_EPOCH
    return {"id": np.arange(n, dtype=np.int64), "sk": sk, "dvalid": dvalid,
            "store": store, "qty": qty, "price": price,
            "pvalid": rng.random(n) >= 0.02, "profit": profit,
            "fvalid": rng.random(n) >= 0.02, "days": days,
            "ts": days * US_PER_DAY + rng.integers(0, US_PER_DAY, n)}


def _pa_decimal(pa, np, unscaled, valid, precision: int, scale: int):
    """A decimal128 Arrow array from int64 unscaled values (the 16-byte
    little-endian words: the value and its sign extension)."""
    words = np.stack([unscaled, unscaled >> 63], axis=1).astype(np.int64)
    return pa.Array.from_buffers(
        pa.decimal128(precision, scale), unscaled.size,
        [pa.py_buffer(np.packbits(valid, bitorder="little")),
         pa.py_buffer(words.tobytes())])


def tpcds_sales_tables(pa, np, t: dict) -> dict:
    """The three tables of Q25-Q27 as pyarrow tables."""
    dv = t["dvalid"]
    sales = pa.table({
        "ss_ticket_number": t["id"],
        "ss_sold_date_sk": pa.array(t["sk"], mask=~dv),
        "ss_store_sk": t["store"], "ss_quantity": t["qty"],
        "ss_ext_sales_price": _pa_decimal(pa, np, t["price"], t["pvalid"],
                                          7, 2),
        "ss_net_profit": _pa_decimal(pa, np, t["profit"], t["fvalid"], 7, 2),
        "ss_sold_date": pa.array(t["days"].astype(np.int32), pa.date32(),
                                 mask=~dv),
        "ss_sold_ts": pa.array(t["ts"], pa.timestamp("us"), mask=~dv)})
    dsk = np.arange(DATE_DIM_FIRST_SK, DATE_DIM_FIRST_SK + DATE_DIM_ROWS,
                    dtype=np.int32)
    ddays = dsk.astype(np.int64) - JULIAN_EPOCH
    years = ddays.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970
    date_dim = pa.table({
        "d_date_sk": dsk,
        "d_date": pa.array(ddays.astype(np.int32), pa.date32()),
        "d_year": years.astype(np.int32)})
    store = pa.table({
        "s_store_sk": np.arange(1, STORES + 1, dtype=np.int32),
        "s_store_id": [item_id(i) for i in range(1, STORES + 1)]})
    return {"store_sales": sales, "date_dim": date_dim, "store": store}


def _iso_days(iso: str) -> int:
    import datetime

    return (datetime.date.fromisoformat(iso)
            - datetime.date(1970, 1, 1)).days


def q25_df(sess, paths: dict, E, A, T):
    """Q25, TPC-DS q5's store channel, as a DataFrame of ``sess`` over
    the tables at ``paths`` (E, A, T: the expression, aggregate and type
    modules of the session's package)."""
    first = E.Cast(E.lit(Q25_FIRST), T.DATE)
    dd = sess.read.parquet(paths["date_dim"]).where(E.And(
        E.GreaterThanOrEqual(E.col("d_date"), first),
        E.LessThanOrEqual(E.col("d_date"),
                          E.DateAdd(first, E.lit(Q25_DAYS)))))
    return (sess.read.parquet(paths["store_sales"])
            .join(dd, [("ss_sold_date_sk", "d_date_sk")])
            .join(sess.read.parquet(paths["store"]),
                  [("ss_store_sk", "s_store_sk")])
            .group_by("s_store_id")
            .agg(A.agg(A.Sum(E.col("ss_ext_sales_price")), "sales"),
                 A.agg(A.Sum(E.col("ss_net_profit")), "profit"))
            .order_by("s_store_id"))


def q27_df(sess, path: str, E, A):
    """Q27, the per-day rollup, as a DataFrame of ``sess`` over the
    store_sales files at ``path``."""
    return (sess.read.parquet(path)
            .group_by("ss_sold_date")
            .agg(A.agg(A.Count(None), "n"),
                 A.agg(A.Sum(E.col("ss_ext_sales_price")), "sales"),
                 A.agg(A.Average(E.col("ss_net_profit")), "avg"),
                 A.agg(A.Min(E.col("ss_net_profit")), "lo"),
                 A.agg(A.Max(E.col("ss_sold_ts")), "last"))
            .order_by("ss_sold_date"))


def q25_oracle(np, t: dict) -> list:
    """Q25's rows: (s_store_id, sales, profit) by store id, the sums as
    ``Decimal`` (None where every input is NULL)."""
    from decimal import Decimal

    d0 = _iso_days(Q25_FIRST)
    keep = t["dvalid"] & (t["days"] >= d0) & (t["days"] <= d0 + Q25_DAYS)
    out = []
    for s in range(1, STORES + 1):
        m = keep & (t["store"] == s)
        sums = []
        for v, ok in (("price", "pvalid"), ("profit", "fvalid")):
            mm = m & t[ok]
            sums.append(Decimal(int(t[v][mm].sum())).scaleb(-2)
                        if mm.any() else None)
        if m.any():
            out.append((item_id(s), *sums))
    return sorted(out)


def q27_oracle(np, t: dict) -> list:
    """Q27's rows by sold date (NULL first): count(*), sum of the price,
    avg of the profit at scale 6 HALF_UP, min of the profit, max of the
    timestamp."""
    import decimal
    from decimal import Decimal

    ctx = decimal.Context(prec=50, rounding=decimal.ROUND_HALF_UP)
    key = np.where(t["dvalid"], t["days"], np.iinfo(np.int64).min)
    order = np.argsort(key, kind="stable")
    bounds = np.flatnonzero(np.diff(key[order])) + 1
    rows = []
    for g in np.split(order, bounds):
        k = None if not t["dvalid"][g[0]] else int(t["days"][g[0]])
        p = g[t["pvalid"][g]]
        f = g[t["fvalid"][g]]
        ts = g[t["dvalid"][g]]
        avg = None
        if f.size:
            avg = (Decimal(int(t["profit"][f].sum())).scaleb(-2, ctx)
                   / Decimal(f.size)).quantize(Decimal("1e-6"), context=ctx)
        rows.append((k, int(g.size),
                     Decimal(int(t["price"][p].sum())).scaleb(-2)
                     if p.size else None, avg,
                     Decimal(int(t["profit"][f].min())).scaleb(-2)
                     if f.size else None,
                     int(t["ts"][ts].max()) if ts.size else None))
    return rows


def _half_up(np, num, den):
    """round_half_up(num / den) on int64 arrays, den > 0."""
    q = np.where(num < 0, -((-num) // den), num // den)
    rem = num - q * den
    return q + np.where(np.abs(rem) * 2 >= den, np.sign(num), 0)


def _ts_text_lens(np, us):
    """Lengths of cast(timestamp as string): 19, plus a '.' and the
    fraction's digits without trailing zeros when it is not 0."""
    frac = us % 1_000_000
    zeros = np.zeros(us.size, np.int64)
    for k in range(1, 6):
        zeros = np.where(frac % 10 ** k == 0, k, zeros)
    return 19 + np.where(frac != 0, 7 - zeros, 0)


def q26_projections(np, t: dict):
    """(name, build(col, lit, E, T), oracle) of Q26's projection. An
    oracle returns ``(data, valid)`` per row (data None: only the
    validity is checked), or for a string ``("text", lens, byte_sums or
    None, valid)``. Date fields come from ``datetime`` over the distinct
    days, gathered."""
    import calendar
    import datetime
    from decimal import Decimal

    days, dv, ts = t["days"], t["dvalid"], t["ts"]
    qty = t["qty"].astype(np.int64)
    pu, pv, fu, fv = t["price"], t["pvalid"], t["profit"], t["fvalid"]
    uniq, inv = np.unique(days, return_inverse=True)
    dates = [datetime.date(1970, 1, 1) + datetime.timedelta(int(d))
             for d in uniq]

    def per_day(fn, dtype=np.int64):
        return np.array([fn(d) for d in dates], dtype)[inv]

    def days_of(d):
        return (d - datetime.date(1970, 1, 1)).days

    d2000 = _iso_days("2000-01-01")
    sod = (ts - days * US_PER_DAY) // 1_000_000
    ones = np.ones(days.size, bool)
    both = pv & fv
    text = [s.isoformat().encode() for s in dates]
    D = Decimal
    return [
        ("year", lambda c, l, E, T: E.Year(c("ss_sold_date")),
         lambda: (per_day(lambda d: d.year), dv)),
        ("quarter", lambda c, l, E, T: E.Quarter(c("ss_sold_date")),
         lambda: (per_day(lambda d: (d.month - 1) // 3 + 1), dv)),
        ("month", lambda c, l, E, T: E.Month(c("ss_sold_date")),
         lambda: (per_day(lambda d: d.month), dv)),
        ("dayofmonth", lambda c, l, E, T: E.DayOfMonth(c("ss_sold_date")),
         lambda: (per_day(lambda d: d.day), dv)),
        ("dayofyear", lambda c, l, E, T: E.DayOfYear(c("ss_sold_ts")),
         lambda: (per_day(lambda d: d.timetuple().tm_yday), dv)),
        ("dayofweek", lambda c, l, E, T: E.DayOfWeek(c("ss_sold_date")),
         lambda: (per_day(lambda d: d.isoweekday() % 7 + 1), dv)),
        ("weekday", lambda c, l, E, T: E.WeekDay(c("ss_sold_date")),
         lambda: (per_day(lambda d: d.weekday()), dv)),
        ("hour", lambda c, l, E, T: E.Hour(c("ss_sold_ts")),
         lambda: (sod // 3600, dv)),
        ("minute", lambda c, l, E, T: E.Minute(c("ss_sold_ts")),
         lambda: (sod // 60 % 60, dv)),
        ("second", lambda c, l, E, T: E.Second(c("ss_sold_ts")),
         lambda: (sod % 60, dv)),
        ("date_add", lambda c, l, E, T: E.DateAdd(c("ss_sold_date"),
                                                   l(30)),
         lambda: (days + 30, dv)),
        ("date_sub", lambda c, l, E, T: E.DateSub(c("ss_sold_date"),
                                                   c("ss_quantity")),
         lambda: (days - qty, dv)),
        ("datediff", lambda c, l, E, T: E.DateDiff(
            c("ss_sold_date"), E.Cast(l("2000-01-01"), T.DATE)),
         lambda: (days - d2000, dv)),
        ("last_day", lambda c, l, E, T: E.LastDay(c("ss_sold_date")),
         lambda: (per_day(lambda d: days_of(d.replace(
             day=calendar.monthrange(d.year, d.month)[1]))), dv)),
        ("trunc_year", lambda c, l, E, T: E.TruncDate(c("ss_sold_date"),
                                                       l("year")),
         lambda: (per_day(lambda d: days_of(d.replace(month=1, day=1))),
                  dv)),
        ("trunc_month", lambda c, l, E, T: E.TruncDate(c("ss_sold_date"),
                                                        l("MM")),
         lambda: (per_day(lambda d: days_of(d.replace(day=1))), dv)),
        ("unix_timestamp", lambda c, l, E, T: E.UnixTimestamp(
            c("ss_sold_ts")),
         lambda: (ts // 1_000_000, dv)),
        ("unix_date", lambda c, l, E, T: E.ToUnixTimestamp(
            c("ss_sold_date")),
         lambda: (days * 86_400, dv)),
        ("from_unixtime", lambda c, l, E, T: E.FromUnixTime(
            E.UnixTimestamp(c("ss_sold_ts")), l("yyyy-MM-dd HH:mm:ss")),
         lambda: ("text", np.full(days.size, 19), None, dv)),
        ("time_add", lambda c, l, E, T: E.TimeAdd(c("ss_sold_ts"), 1,
                                                   3_600_000_000),
         lambda: (ts + US_PER_DAY + 3_600_000_000, dv)),
        ("date_to_ts", lambda c, l, E, T: E.Cast(c("ss_sold_date"),
                                                  T.TIMESTAMP),
         lambda: (days * US_PER_DAY, dv)),
        ("ts_to_date", lambda c, l, E, T: E.Cast(c("ss_sold_ts"), T.DATE),
         lambda: (days, dv)),
        ("date_text", lambda c, l, E, T: E.Cast(c("ss_sold_date"),
                                                 T.STRING),
         lambda: ("text", np.full(days.size, 10),
                  np.array([sum(b) for b in text], np.int64)[inv], dv)),
        ("date_text_back", lambda c, l, E, T: E.Cast(E.Cast(
            c("ss_sold_date"), T.STRING), T.DATE),
         lambda: (days, dv)),
        ("ts_text", lambda c, l, E, T: E.Cast(c("ss_sold_ts"), T.STRING),
         lambda: ("text", _ts_text_lens(np, ts), None, dv)),
        ("ts_text_back", lambda c, l, E, T: E.Cast(E.Cast(
            c("ss_sold_ts"), T.STRING), T.TIMESTAMP),
         lambda: (ts, dv)),
        ("price_plus_profit", lambda c, l, E, T: E.Add(
            c("ss_ext_sales_price"), c("ss_net_profit")),
         lambda: (pu + fu, both)),
        ("price_minus_qty", lambda c, l, E, T: E.Subtract(
            c("ss_ext_sales_price"), c("ss_quantity")),
         lambda: (pu - qty * 100, pv)),
        ("price_times_qty", lambda c, l, E, T: E.Multiply(
            c("ss_ext_sales_price"), c("ss_quantity")),
         lambda: (pu * qty, pv)),
        ("price_times_profit", lambda c, l, E, T: E.Multiply(
            c("ss_ext_sales_price"), c("ss_net_profit")),
         lambda: (pu * fu, both)),
        ("price_over_qty", lambda c, l, E, T: E.Divide(
            c("ss_ext_sales_price"), c("ss_quantity")),
         lambda: (_half_up(np, pu * 10 ** 11, qty), pv)),
        ("price_over_profit", lambda c, l, E, T: E.Divide(
            c("ss_ext_sales_price"), c("ss_net_profit")),
         lambda: (_half_up(np, np.where(fu < 0, -pu, pu) * 10 ** 10,
                           np.maximum(np.abs(fu), 1)), both & (fu != 0))),
        ("price_to_int", lambda c, l, E, T: E.Cast(c("ss_ext_sales_price"),
                                                    T.INT),
         lambda: (pu // 100, pv)),
        ("profit_to_bigint", lambda c, l, E, T: E.Cast(
            c("ss_net_profit"), T.LONG),
         lambda: (np.where(fu < 0, -((-fu) // 100), fu // 100), fv)),
        ("profit_to_double", lambda c, l, E, T: E.Cast(
            c("ss_net_profit"), T.DOUBLE),
         lambda: (fu / 100.0, fv)),
        ("price_to_dec9_4", lambda c, l, E, T: E.Cast(
            c("ss_ext_sales_price"), T.DecimalType(9, 4)),
         lambda: (pu * 100, pv)),
        ("profit_to_dec5_0", lambda c, l, E, T: E.Cast(
            c("ss_net_profit"), T.DecimalType(5, 0)),
         lambda: (_half_up(np, fu, 100), fv)),
        ("qty_to_dec5_2", lambda c, l, E, T: E.Cast(c("ss_quantity"),
                                                     T.DecimalType(5, 2)),
         lambda: (qty * 100, ones)),
        ("price_gt_lit", lambda c, l, E, T: E.GreaterThan(
            c("ss_ext_sales_price"), l(D("100.50"))),
         lambda: (pu > 10_050, pv)),
        ("profit_le_lit", lambda c, l, E, T: E.LessThanOrEqual(
            c("ss_net_profit"), l(D("-12.3"))),
         lambda: (fu <= -1_230, fv)),
        ("price_gt_profit_dec9_4", lambda c, l, E, T: E.GreaterThan(
            c("ss_ext_sales_price"), E.Cast(c("ss_net_profit"),
                                            T.DecimalType(9, 4))),
         lambda: (pu > fu, both)),
        ("minus_profit", lambda c, l, E, T: E.UnaryMinus(
            c("ss_net_profit")),
         lambda: (-fu, fv)),
        ("abs_profit", lambda c, l, E, T: E.Abs(c("ss_net_profit")),
         lambda: (np.abs(fu), fv)),
    ]


def _byte_sums(torch, offsets, chars, n: int):
    """Per-row sums of a string column's bytes."""
    cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=chars.device),
                    torch.cumsum(chars.to(torch.int64), 0)])
    o = offsets[: n + 1].long()
    return cs[o[1:]] - cs[o[:-1]]


def q26_check(torch, np, batches, projs, wants, dev):
    """Hold every output of Q26's batches to its oracle on the card:
    validity and (valid) values equal, doubles bit for bit; a string's
    lengths and, where given, byte sums. Returns each output's checksum
    (the sum of its valid values, or of a string's lengths)."""
    sums = {name: 0 for name, _, _ in projs}
    rows = 0
    for b in batches:
        n = int(b.num_rows)
        rows += n
        ids = b.columns[0].data[:n]
        for (name, _, _), col, want in zip(projs, b.columns[1:], wants):
            v = col.validity[:n]
            if not torch.equal(v, want[-1][ids]):
                raise AssertionError(f"Q26 {name}: validity differs")
            if isinstance(want[0], str):
                lens = (col.offsets[1:n + 1] - col.offsets[:n]).to(torch.int64)
                got = torch.where(v, lens, 0)
                if not torch.equal(got, torch.where(v, want[1][ids], 0)):
                    raise AssertionError(f"Q26 {name}: lengths differ")
                if want[2] is not None and not torch.equal(
                        torch.where(v, _byte_sums(torch, col.offsets,
                                                  col.chars, n), 0),
                        torch.where(v, want[2][ids], 0)):
                    raise AssertionError(f"Q26 {name}: bytes differ")
                sums[name] += int(got.sum())
                continue
            got = col.data[:n]
            exp = want[0][ids].to(got.dtype)
            if got.is_floating_point():
                got, exp = got.view(torch.int64), exp.view(torch.int64)
            got = torch.where(v, got, torch.zeros_like(got))
            if not torch.equal(got, torch.where(v, exp, torch.zeros_like(
                    exp))):
                bad = int(torch.nonzero(got != torch.where(
                    v, exp, torch.zeros_like(exp)))[0])
                raise AssertionError(
                    f"Q26 {name}: row {int(ids[bad])}: {got[bad].item()} != "
                    f"{exp[bad].item()}")
            sums[name] += int(got.to(torch.int64).sum())
    return rows, sums


def dates_query(torch, q: str, sess, df_of, check, rows: int, nbytes: int,
                expect) -> dict:
    """One query of the item-6 phase through the session: ``explain()``
    must show no CPU node, then :func:`exchange_query`'s walls, launch
    check (``expect(counts)``), exchanges and profile."""
    text = df_of().explain()
    if any(ln.lstrip().startswith("!") for ln in text.splitlines()):
        raise AssertionError(f"{q}: part of the plan falls back:\n{text}")
    counts = exchange_query(torch, q, sess, df_of, check, "Tpu", rows,
                            nbytes, expect)
    emit({"query": q, "explain": text.splitlines()})
    return counts


def decimal_date_phase(torch, np, dev) -> dict:
    """Q25, Q25a, Q26 and Q27 (see the module docstring) over the tables
    of :func:`tpcds_sales_tables`, written under ``_chip_data/`` and
    removed after. Returns each path's launches."""
    import datetime
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql import session as S

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, PARQUET_DIR)
    shutil.rmtree(base, ignore_errors=True)
    n = 1 << SALES_LOG2_ROWS
    t = store_sales_table(np, n)
    tables = tpcds_sales_tables(pa, np, t)
    paths = {k: os.path.join(base, k) for k in tables}
    per_query = {}

    def fresh(settings):
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        return S.TpuSession(settings, device=dev)

    try:
        write_s = _write_files(pa, pq, paths["store_sales"],
                               tables["store_sales"], MULTI_FILES,
                               store_decimal_as_integer=True)
        write_s += _write_files(pa, pq, paths["date_dim"],
                                tables["date_dim"], 1)
        write_s += _write_files(pa, pq, paths["store"], tables["store"], 1)
        emit({"table": "store_sales, date_dim, store",
              "files": [MULTI_FILES, 1, 1], "rows": n,
              "date_dim_rows": DATE_DIM_ROWS, "stores": STORES,
              "write_s": write_s})

        # --- Q25 / Q25a: TPC-DS q5's store channel --------------------------
        want25 = q25_oracle(np, t)

        def check25(rows, q):
            if rows != want25:
                raise AssertionError(f"{q}: {rows[:3]} != {want25[:3]}")

        for q, strategy in (("Q25", "PALLAS"), ("Q25a", "AUTO")):
            sess = fresh({"spark.rapids.tpu.sql.join.strategy": strategy})

            def expect(c, strategy=strategy):
                # s_store_id groups on the sort path: the RADIX kernel
                return c["radix_segment_reduce"] > 0 and (
                    strategy != "PALLAS" or c["probe_ranges"] > 0)

            per_query[q] = dates_query(
                torch, q, sess,
                lambda sess=sess: q25_df(sess, paths, E, A, T),
                lambda rows, q=q: check25(rows, q), n, n * 20 + 73_049 * 12,
                expect)

        # --- Q26: every item-6 function in one projection -------------------
        projs = q26_projections(np, t)
        sess = fresh({"spark.rapids.tpu.sql.castStringToTimestamp.enabled":
                      True})
        wants = [tuple(a if a is None or isinstance(a, str)
                       else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in oracle()) for _, _, oracle in projs]

        def q26_df():
            return sess.read.parquet(paths["store_sales"]).select(
                col("ss_ticket_number"),
                *[E.Alias(build(col, lit, E, T), name)
                  for name, build, _ in projs])

        outs = []

        def run26():
            plan = sess._execute(q26_df().node).tpu_child
            outs[:] = [b for p in range(plan.num_partitions)
                       for b in plan.execute_partition(p)]
            return outs

        def check26(batches):
            got, sums = q26_check(torch, np, batches, projs, wants, dev)
            if got != n:
                raise AssertionError(f"Q26: {got} rows, expected {n}")
            outs.append(sums)

        text = q26_df().explain()
        if any(ln.lstrip().startswith("!") for ln in text.splitlines()):
            raise AssertionError(f"Q26: part of the plan falls back:\n"
                                 f"{text}")
        cold, warm, counts = _walls(torch, "Q26", run26, check26)
        if any(counts.values()):
            raise AssertionError(f"Q26 launched {counts}")
        sums = outs[-1]
        rng = np.random.default_rng(26)
        b0 = outs[0]
        m = int(b0.num_rows)
        idx = np.sort(rng.choice(m, min(m, 1 << 12), replace=False))
        sample = _sample_rows(torch, b0, torch.from_numpy(idx).to(dev))
        names = [p[0] for p in projs]
        for i in range(idx.size):
            r = int(sample[0][i])
            for name, fmt in (("date_text", "%Y-%m-%d"),
                              ("ts_text", None),
                              ("from_unixtime", "%Y-%m-%d %H:%M:%S")):
                g = sample[1 + names.index(name)][i]
                if not t["dvalid"][r]:
                    want = None
                else:
                    dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(
                        microseconds=int(t["ts"][r]))
                    if name == "date_text":
                        want = dt.date().isoformat()
                    elif name == "from_unixtime":
                        want = dt.strftime(fmt)
                    else:
                        want = dt.isoformat(" ")
                        if "." in want:
                            want = want.rstrip("0")
                if g != want:
                    raise AssertionError(f"Q26 {name} row {r}: {g!r} != "
                                         f"{want!r}")
        del outs[:]
        nbytes = n * (8 + 4 + 4 + 8 + 8 + 4 + 8)
        per_query["Q26"] = counts
        emit({"query": "Q26", "rows": n, "functions": names,
              "checksums": sums, "sample_rows": int(idx.size),
              "cold_wall_ms": cold, "warm_wall_ms": warm, "bytes": nbytes,
              "bound_ms": bound_ms(nbytes), "launches": counts,
              "explain": text.splitlines()})
        profile_run(torch, "Q26", lambda: _timed(torch, run26), n, nbytes,
                    unprofiled=0)
        del outs[:]

        # --- Q27: a date-keyed decimal aggregate ----------------------------
        want27 = q27_oracle(np, t)
        sess = fresh({})

        def q27():
            return q27_df(sess, paths["store_sales"], E, A)

        def check27(rows):
            if rows != want27:
                bad = next(i for i, (a, b) in enumerate(zip(rows, want27))
                           if a != b) if len(rows) == len(want27) else None
                raise AssertionError(
                    f"Q27: {len(rows)} rows (want {len(want27)}), first "
                    f"difference at {bad}: "
                    f"{rows[bad] if bad is not None else ''} != "
                    f"{want27[bad] if bad is not None else ''}")

        per_query["Q27"] = dates_query(
            torch, "Q27", sess, q27, check27, n, n * (4 + 4 + 4 + 8),
            lambda c: c["bucket_sum"] > 0 and c["bucket_winner"] > 0)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return per_query


# ---------------------------------------------------------------------------
# item 8: nested-loop and cartesian joins
# ---------------------------------------------------------------------------
#: TPC-DS q88's eight half-hour slots: (hour, 0 for :00-:29, 1 for :30-:59)
Q30_SLOTS = ((8, 1), (9, 0), (9, 1), (10, 0), (10, 1), (11, 0), (11, 1),
             (12, 0))
#: TPC-DS q88's household filter: (hd_dep_count, largest hd_vehicle_count)
Q30_HOUSEHOLDS = ((4, 6), (2, 4), (0, 2))
TIME_DIM_ROWS = 86_400
HOUSEHOLD_ROWS = 7_200
#: s_store_name of stores 1-12 (dsdgen draws them from these syllables)
STORE_NAMES = ("able", "ought", "ese", "anti", "cally", "bar", "eing",
               "pri", "ation", "n st", "ese", "ought")
#: TPC-DS income_band: 20 bands of 10 000 up to 200 000
INCOME_BANDS = 20
INCOME_BAND_WIDTH = 10_000


def q30_tables(pa, np, n: int) -> tuple:
    """TPC-DS q88's four tables: store_sales (Q25's rows and stores,
    ``rng(30)`` sold times and household keys, 3% NULL each), time_dim
    (one row a second), household_demographics (7 200 rows: dependents
    0-9 by the key's last digit, vehicles -1 to 4) and store (the names
    of :data:`STORE_NAMES`). Returns (pyarrow tables, the numpy columns
    the oracle reads)."""
    t = store_sales_table(np, n)
    rng = np.random.default_rng(30)
    tsk = rng.integers(0, TIME_DIM_ROWS, n).astype(np.int32)
    tvalid = rng.random(n) >= 0.03
    hsk = rng.integers(1, HOUSEHOLD_ROWS + 1, n).astype(np.int32)
    hvalid = rng.random(n) >= 0.03
    tables = {
        "store_sales": pa.table({
            "ss_sold_time_sk": pa.array(tsk, mask=~tvalid),
            "ss_hdemo_sk": pa.array(hsk, mask=~hvalid),
            "ss_store_sk": t["store"]}),
        "time_dim": pa.table({
            "t_time_sk": np.arange(TIME_DIM_ROWS, dtype=np.int32),
            "t_hour": (np.arange(TIME_DIM_ROWS) // 3600).astype(np.int32),
            "t_minute": (np.arange(TIME_DIM_ROWS) // 60 % 60).astype(
                np.int32)}),
        "household_demographics": pa.table({
            "hd_demo_sk": np.arange(1, HOUSEHOLD_ROWS + 1, dtype=np.int32),
            "hd_dep_count": (np.arange(HOUSEHOLD_ROWS) % 10).astype(
                np.int32),
            "hd_vehicle_count": (np.arange(HOUSEHOLD_ROWS) // 10 % 6
                                 - 1).astype(np.int32)}),
        "store": pa.table({
            "s_store_sk": np.arange(1, STORES + 1, dtype=np.int32),
            "s_store_name": list(STORE_NAMES)})}
    return tables, {"tsk": tsk, "tvalid": tvalid, "hsk": hsk,
                    "hvalid": hvalid, "store": t["store"]}


def q30_oracle(np, c: dict) -> list:
    """Q30's one row: each slot's count of store_sales rows at an 'ese'
    store, in the slot, of a household the filter keeps."""
    hour, minute = c["tsk"] // 3600, c["tsk"] // 60 % 60
    dep, veh = (c["hsk"] - 1) % 10, (c["hsk"] - 1) // 10 % 6 - 1
    hh = np.zeros(c["hsk"].size, bool)
    for d, v in Q30_HOUSEHOLDS:
        hh |= (dep == d) & (veh <= v)
    ese = np.array([nm == "ese" for nm in STORE_NAMES])[c["store"] - 1]
    keep = c["tvalid"] & c["hvalid"] & hh & ese
    return [tuple(int((keep & (hour == h) & ((minute >= 30) == bool(half)))
                      .sum()) for h, half in Q30_SLOTS)]


def q30_df(sess, paths: dict, E, A):
    """Q30, TPC-DS q88: eight count(*) subqueries over store_sales joined
    to household_demographics, time_dim and store, each filtered to one
    half-hour slot, cross-joined into one row (seven cartesian
    products). The dimension filters sit on their scans, where Spark's
    optimizer pushes them."""
    col, lit = E.col, E.lit
    hd_cond = None
    for d, v in Q30_HOUSEHOLDS:
        c = E.And(E.EqualTo(col("hd_dep_count"), lit(d)),
                  E.LessThanOrEqual(col("hd_vehicle_count"), lit(v)))
        hd_cond = c if hd_cond is None else E.Or(hd_cond, c)
    hd = sess.read.parquet(paths["household_demographics"]).where(hd_cond)
    st = sess.read.parquet(paths["store"]).where(
        E.EqualTo(col("s_store_name"), lit("ese")))
    out = None
    for h, half in Q30_SLOTS:
        minute = (E.GreaterThanOrEqual(col("t_minute"), lit(30)) if half
                  else E.LessThan(col("t_minute"), lit(30)))
        td = sess.read.parquet(paths["time_dim"]).where(
            E.And(E.EqualTo(col("t_hour"), lit(h)), minute))
        one = (sess.read.parquet(paths["store_sales"])
               .join(hd, [("ss_hdemo_sk", "hd_demo_sk")])
               .join(td, [("ss_sold_time_sk", "t_time_sk")])
               .join(st, [("ss_store_sk", "s_store_sk")])
               .agg(A.agg(A.Count(None), f"h{h}_{30 * half}")))
        out = one if out is None else out.cross_join(one)
    return out


def q31_df(sess, paths: dict, E, A):
    """Q31, a band join: every income row against TPC-DS income_band on
    ``v between ib_lower_bound and ib_upper_bound``, then count and sum
    per band."""
    col = E.col
    cond = E.And(E.GreaterThanOrEqual(col("v"), col("ib_lower_bound")),
                 E.LessThanOrEqual(col("v"), col("ib_upper_bound")))
    return (sess.read.parquet(paths["incomes"])
            .cross_join(sess.read.parquet(paths["income_band"]), cond)
            .group_by("ib_income_band_sk")
            .agg(A.agg(A.Count(None), "n"), A.agg(A.Sum(col("v")), "s"))
            .order_by("ib_income_band_sk"))


def q31_oracle(np, v) -> list:
    """Q31's rows: (band, count, sum) of the incomes in each band
    (0-10 000, 10 001-20 000, ...)."""
    band = np.where(v == 0, 1, (v - 1) // INCOME_BAND_WIDTH + 1)
    cnt = np.bincount(band, minlength=INCOME_BANDS + 1)
    tot = np.bincount(band, weights=v.astype(np.float64),
                      minlength=INCOME_BANDS + 1)
    return [(b, int(cnt[b]), int(tot[b]))
            for b in range(1, INCOME_BANDS + 1) if cnt[b]]


def nested_loop_phase(torch, np, dev) -> dict:
    """Q30 (TPC-DS q88, seven cartesian products of one-row counts) and
    Q31 (a band join of 2^23 incomes against income_band's 20 rows, 4
    probe batches of 4.2e7 pairs each) through the port session over
    parquet files under ``_chip_data/`` (removed after), each against its
    numpy oracle. Returns each path's launches."""
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.exec.join import (
        TpuBroadcastNestedLoopJoinExec, TpuCartesianProductExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql import session as S

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, PARQUET_DIR)
    shutil.rmtree(base, ignore_errors=True)
    n = 1 << SALES_LOG2_ROWS
    per_query = {}

    def fresh():
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        return S.TpuSession({}, device=dev)

    def no_fallback(q, df):
        text = df.explain()
        if any(ln.lstrip().startswith("!") for ln in text.splitlines()):
            raise AssertionError(f"{q}: part of the plan falls back:\n"
                                 f"{text}")

    def count_execs(sess, cls) -> int:
        return sum(isinstance(e, cls) for e in _device_tree(
            sess.last_executed_plan.tpu_child))

    try:
        tables, cols = q30_tables(pa, np, n)
        paths = {k: os.path.join(base, k) for k in tables}
        write_s = sum(_write_files(pa, pq, paths[k], tb,
                                   MULTI_FILES if k == "store_sales" else 1)
                      for k, tb in tables.items())
        rng = np.random.default_rng(31)
        v = rng.integers(0, INCOME_BANDS * INCOME_BAND_WIDTH + 1,
                         n).astype(np.int32)
        lower = np.arange(INCOME_BANDS) * INCOME_BAND_WIDTH + 1
        lower[0] = 0
        paths["incomes"] = os.path.join(base, "incomes")
        paths["income_band"] = os.path.join(base, "income_band")
        write_s += _write_files(pa, pq, paths["incomes"], pa.table({"v": v}),
                                MULTI_FILES)
        write_s += _write_files(pa, pq, paths["income_band"], pa.table({
            "ib_income_band_sk": np.arange(1, INCOME_BANDS + 1,
                                           dtype=np.int32),
            "ib_lower_bound": lower.astype(np.int32),
            "ib_upper_bound": (np.arange(1, INCOME_BANDS + 1)
                               * INCOME_BAND_WIDTH).astype(np.int32)}), 1)
        emit({"table": "q88 store_sales, time_dim, household_demographics, "
              "store; incomes, income_band", "rows": n,
              "files": MULTI_FILES, "write_s": write_s})

        # --- Q30: TPC-DS q88 ----------------------------------------------
        want30 = q30_oracle(np, cols)
        sess = fresh()

        def q30():
            return q30_df(sess, paths, E, A)

        def check30(rows):
            if rows != want30:
                raise AssertionError(f"Q30: {rows} != {want30}")

        no_fallback("Q30", q30())
        per_query["Q30"] = exchange_query(
            torch, "Q30", sess, q30, check30, "TpuCartesianProductExec", n,
            n * 12 + TIME_DIM_ROWS * 12 + HOUSEHOLD_ROWS * 12)
        cart = count_execs(sess, TpuCartesianProductExec)
        if cart != len(Q30_SLOTS) - 1:
            raise AssertionError(f"Q30: {cart} cartesian products")
        emit({"query": "Q30", "cartesian_products": cart,
              "counts": want30[0]})

        # --- Q31: a band join ----------------------------------------------
        want31 = q31_oracle(np, v)
        sess = fresh()

        def q31():
            return q31_df(sess, paths, E, A)

        def check31(rows):
            if rows != want31:
                raise AssertionError(f"Q31: {rows[:3]} != {want31[:3]}")

        no_fallback("Q31", q31())
        per_query["Q31"] = exchange_query(
            torch, "Q31", sess, q31, check31,
            "TpuBroadcastNestedLoopJoinExec", n, n * 4 + INCOME_BANDS * 12,
            lambda c: c["bucket_sum"] > 0)
        emit({"query": "Q31", "probe_batches": MULTI_FILES,
              "pairs_per_batch": (n // MULTI_FILES) * INCOME_BANDS,
              "nested_loop_joins": count_execs(
                  sess, TpuBroadcastNestedLoopJoinExec)})
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return per_query


# ---------------------------------------------------------------------------
# item 27: the native host decoders
# ---------------------------------------------------------------------------
#: decode-pool sizes of Q11's host-only timing (DECODE_THREADS' sweep)
DECODE_SWEEP = (1, 2, 4, 8)
#: hybrid streams the queries decoded, by route (``query_routes``)
QUERY_ROUTES = {"native": 0, "numpy": 0}


def decode_routes() -> dict:
    from spark_rapids_tpu_torch.io import parquet_device as PD

    return dict(PD.DECODE_ROUTES)


def query_routes(q: str, before: dict) -> dict:
    """The hybrid streams decoded by route since ``before``, added to
    :data:`QUERY_ROUTES`; a stream of a query on the numpy route fails
    the run (the card's machine has a C++ compiler)."""
    now = decode_routes()
    got = {k: now[k] - before[k] for k in now}
    for k, v in got.items():
        QUERY_ROUTES[k] += v
    if got["numpy"]:
        raise AssertionError(f"{q}: {got['numpy']} hybrid streams took the "
                             "numpy decoder")
    return got


@contextlib.contextmanager
def decode_pool_size(threads: int):
    """The parquet scan's host-decode pool at ``threads`` threads."""
    from spark_rapids_tpu_torch.io import parquet_device as PD

    def fresh(n):
        if PD._PQDEC_POOL is not None:
            PD._PQDEC_POOL.shutdown(wait=True)
        PD._PQDEC_POOL = None
        PD.DECODE_THREADS = n

    old = PD.DECODE_THREADS
    fresh(threads)
    try:
        yield
    finally:
        fresh(old)


def host_decode_timing(np, path: str, sweep=(1, 8)) -> dict:
    """Every column chunk of the parquet file(s) at ``path`` planned on
    the host alone (``parquet_device.plan_chunk``: decompress, the hybrid
    streams, the dictionary pages; no upload): through the C++ decoder on
    each pool size of ``sweep``, and through the numpy decoder (the
    library hidden, as on a host without a compiler) on one thread.
    Seconds, best of two passes each (the file in the page cache)."""
    import glob
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.io import parquet_device as PD

    files = sorted(glob.glob(os.path.join(path, "*.parquet"))) \
        if os.path.isdir(path) else [path]
    chunks = []
    for f in files:
        with open(f, "rb") as fh:
            data = fh.read()
        pf = pq.ParquetFile(f)
        md = pf.metadata
        for rg in range(md.num_row_groups):
            for ci in range(md.num_columns):
                col = pf.schema.column(ci)
                chunks.append((data, md.row_group(rg).column(ci), col))

    def plan(c):
        data, cmd, col = c
        try:
            PD.plan_chunk(data, cmd, col.max_definition_level,
                          col.max_repetition_level, PD.column_time_unit(col))
            return 1
        except PD._FallbackError:  # chunks the host reader takes
            return 0

    #: chunks planned on the device route, per pass of every timing: each
    #: pass must do the same work, or the times compare different things
    planned = []

    def best(threads: int) -> float:
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            if threads == 1:
                planned.append(sum(map(plan, chunks)))
            else:
                with ThreadPoolExecutor(threads) as pool:
                    planned.append(sum(pool.map(plan, chunks)))
            times.append(time.perf_counter() - t0)
        return min(times)

    out = {"files": len(files), "chunks": len(chunks),
           "file_bytes": sum(os.path.getsize(f) for f in files)}
    out["native_s"] = {t: best(t) for t in sweep}
    hidden = (native.pq_hybrid_decode, native.pq_binary_dict)
    before = decode_routes()
    native.pq_hybrid_decode = native.pq_binary_dict = (
        lambda *a, **k: None)
    try:
        out["numpy_s"] = best(1)
    finally:
        native.pq_hybrid_decode, native.pq_binary_dict = hidden
    after = decode_routes()
    out["numpy_streams"] = after["numpy"] - before["numpy"]
    out["planned_chunks"] = planned[0]
    if not out["numpy_streams"] or after["native"] != before["native"]:
        raise AssertionError(f"host decode timing of {path}: routes "
                             f"{before} -> {after}")
    if len(set(planned)) != 1:
        raise AssertionError(f"host decode timing of {path}: chunks "
                             f"planned per pass {planned}")
    return out


# ---------------------------------------------------------------------------
# item 25: rand, ids, partition ids, file names and hash (Q28)
# ---------------------------------------------------------------------------
_U64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _splitmix_int(z: int) -> int:
    z = (z + _GOLDEN) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def rand_oracle(np, seed: int, pid: int, n: int):
    """rand(seed) of rows 0..n-1 of partition ``pid``: splitmix64 over
    (seed, partition, row), top 53 bits / 2^53 (the reference's stream),
    in ``np.uint64``."""
    base = _splitmix_int((seed & _U64) ^ ((pid * _GOLDEN) & _U64))
    z = np.arange(n, dtype=np.uint64) ^ np.uint64(base)
    z = z + np.uint64(_GOLDEN)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _m3_mixk1(np, k):
    k = k * np.uint32(0xCC9E2D51)
    k = (k << np.uint32(15)) | (k >> np.uint32(17))
    return k * np.uint32(0x1B873593)


def _m3_mixh1(np, h, k):
    h = h ^ k
    h = (h << np.uint32(13)) | (h >> np.uint32(19))
    return h * np.uint32(5) + np.uint32(0xE6546B64)


def _m3_fmix(np, h, length: int):
    h = h ^ np.uint32(length)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def murmur3_oracle(np, one_byte_strings, doubles, seed: int = 42):
    """Spark's hash(s1, ..., d) per row (int32) for non-null one-byte
    strings (uint8 arrays) then a double, in numpy uint32 arithmetic."""
    h = np.full(doubles.shape[0], seed, np.uint32)
    for b in one_byte_strings:
        k = b.astype(np.int8).astype(np.int32).astype(np.uint32)
        h = _m3_fmix(np, _m3_mixh1(np, h, _m3_mixk1(np, k)), 1)
    d = np.where(doubles == 0.0, 0.0, doubles)
    bits = d.view(np.uint64)
    h = _m3_mixh1(np, h, _m3_mixk1(np, (bits & np.uint64(0xFFFFFFFF))
                                   .astype(np.uint32)))
    h = _m3_mixh1(np, h, _m3_mixk1(np, (bits >> np.uint64(32))
                                   .astype(np.uint32)))
    return _m3_fmix(np, h, 8).view(np.int32)


def q28_queries(torch, np, sess, path: str, t: dict, strs: dict,
                per_query: dict) -> None:
    """Q28 and Q28i over the lineitem files at ``path`` (see the module
    docstring), each through :func:`exchange_query`."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.expr.nondet import murmur3_scalar

    n = t["qty"].shape[0]
    names = ["l_returnflag", "l_linestatus", "l_shipmode", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
    # the partitions in split order: each file's rows, numbered in the file
    probe = sess.read.parquet(path).select(col("l_quantity"))
    probe.collect()
    scan = next(e for e in _device_tree(sess.last_executed_plan.tpu_child)
                if isinstance(e, TpuFileSourceScanExec))
    per = -(-n // MULTI_FILES)
    parts = []
    for pid, sp in enumerate(scan.scanner.splits()):
        i = int(os.path.basename(sp.path)[len("part-"):-len(".parquet")])
        parts.append((pid, sp.path, i * per, min(n, (i + 1) * per)))
    keep = np.zeros(n, bool)
    for pid, _, a, b in parts:
        keep[a:b] = rand_oracle(np, 42, pid, b - a) < 0.25
    sub = {k: v[keep] for k, v in t.items()}
    want, _ = q17_oracle(np, sub)

    def q28():
        sampled = (sess.read.parquet(path)
                   .select(*[col(c) for c in names],
                           E.Alias(E.Rand(42), "r"))
                   .where(E.LessThan(col("r"), lit(0.25))))
        return tpch_q1_df(np, sess, path, source=sampled)

    per_query["Q28"] = exchange_query(
        torch, "Q28", sess, q28, lambda rows: tpch_q1_check(want, rows,
                                                            "Q28"),
        "TpuShuffleExchangeExec", n, n * (4 * 8 + 4) + 3 * 5 * n,
        lambda c: c["bucket_sum"] > 0 and c["bucket_float_sum"] > 0)
    emit({"query": "Q28", "sampled_rows": int(keep.sum()),
          "partitions": [(pid, os.path.basename(f), b - a)
                         for pid, f, a, b in parts]})

    codes = {k: strs[k][1][strs[k][0][:-1]] for k in
             ("l_returnflag", "l_linestatus")}  # one byte a row
    h = murmur3_oracle(np, [codes["l_returnflag"], codes["l_linestatus"]],
                       t["qty"])
    want_i = sorted(
        (f, b - a, (pid << 33), (pid << 33) + (b - a) - 1, pid, pid,
         int(h[a:b].astype(np.int64).sum())) for pid, f, a, b in parts)

    def ids():
        return sess.read.parquet(path).select(
            E.Alias(E.MonotonicallyIncreasingID(), "id"),
            E.Alias(E.SparkPartitionID(), "pid"),
            E.Alias(E.InputFileName(), "f"),
            E.Alias(E.Murmur3Hash((col("l_returnflag"), col("l_linestatus"),
                                   col("l_quantity"))), "h"))

    def q28i():
        return (ids().group_by("f")
                .agg(A.agg(A.Count(None), "n"),
                     A.agg(A.Min(col("id")), "min_id"),
                     A.agg(A.Max(col("id")), "max_id"),
                     A.agg(A.Min(col("pid")), "min_pid"),
                     A.agg(A.Max(col("pid")), "max_pid"),
                     A.agg(A.Sum(E.Cast(col("h"), T.LONG)), "sum_h"))
                .order_by("f"))

    def check_i(rows):
        if sorted(rows) != want_i:
            raise AssertionError(f"Q28i: {sorted(rows)} != {want_i}")

    per_query["Q28i"] = exchange_query(
        torch, "Q28i", sess, q28i, check_i, "TpuShuffleExchangeExec", n,
        n * 17, lambda c: True)
    # the hashes of a 4096-row sample (partition 0's first rows) against
    # the port's scalar murmur3
    pid0, f0, a0, _ = parts[0]
    sample = sorted(ids().where(E.LessThan(col("id"), lit(4096)))
                    .select(col("id"), col("h")).collect())
    flags = strs["l_returnflag"]
    status = strs["l_linestatus"]

    def s_of(planes, r):
        off, chars = planes
        return bytes(chars[off[r]:off[r + 1]]).decode()

    exp = [(r, murmur3_scalar(float(t["qty"][a0 + r]), T.DOUBLE,
                              murmur3_scalar(s_of(status, a0 + r), T.STRING,
                                             murmur3_scalar(
                                                 s_of(flags, a0 + r),
                                                 T.STRING, 42))))
           for r in range(4096)]
    if sample != exp or any(g != int(h[a0 + r]) for r, g in sample):
        raise AssertionError("Q28i: the sample's hashes differ from the "
                             "scalar murmur3")
    emit({"query": "Q28i", "files": want_i, "hash_sample_rows": 4096})


# ---------------------------------------------------------------------------
# the memory plane (Q29): OOM retry, split-and-retry and spill
# ---------------------------------------------------------------------------
#: Q29b's cap factors, tried in order until the probe splits and recovers
Q29B_FACTORS = (0.8, 0.7, 0.9, 0.6)


def memory_phase(torch, np, dev) -> dict:
    """Q29a-c (see the module docstring). Returns each path's launches."""
    import gc
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.memory import retry as R
    from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
    from spark_rapids_tpu_torch.sql import session as S

    per_query = {}
    here = os.path.dirname(os.path.abspath(__file__))
    base_dir = os.path.join(here, PARQUET_DIR)
    no_backoff = {"spark.rapids.tpu.memory.oomRetry.backoffMs": 0}

    def measured(run):
        """(result, wall ms, peak bytes above what was allocated before,
        launches, the harness's stats)."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launches()
        R.reset_stats()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (out, ms, torch.cuda.max_memory_allocated() - before,
                launches(), R.stats())

    # --- Q29a: Q20v's TPC-H Q1, a fault at every full-size update --------
    n = 1 << STRING_LOG2_ROWS
    t, want, kept, strs = lineitem_inputs(np, n)
    pdir = os.path.join(base_dir, "lineitem_dict")
    shutil.rmtree(base_dir, ignore_errors=True)
    os.makedirs(pdir)
    try:
        pq.write_table(pa.table({
            **{k: _pa_strings(pa, np, v) for k, v in strs.items()},
            "l_quantity": t["qty"], "l_extendedprice": t["price"],
            "l_discount": t["disc"], "l_tax": t["tax"],
            "l_shipdate": t["ship"]}), os.path.join(pdir, "t.parquet"),
            row_group_size=n // Q17_ROW_GROUPS)
        vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
               **no_backoff}
        sess = S.TpuSession(vfa, device=dev)
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        tpch_q1_check(want, tpch_q1_df(np, sess, pdir).collect(), "Q29a")
        rows0, ms0, peak0, c0, _ = measured(
            lambda: tpch_q1_df(np, sess, pdir).collect())
        threshold = (n // Q17_ROW_GROUPS) // 2
        spec = f"TpuHashAggregateExec>{threshold}"
        try:
            fsess = S.TpuSession({**vfa, "spark.rapids.tpu.test.faults.oom":
                                  spec}, device=dev)
            rows1, ms1, peak1, c1, st = measured(
                lambda: tpch_q1_df(np, fsess, pdir).collect())
            fired = len(faults.active().fired())
        finally:
            faults.uninstall()
        tpch_q1_check(want, rows1, "Q29a")
        agg = st.get("TpuHashAggregateExec", {})
        if not (agg.get("max_depth") == 1 and agg.get("splits") ==
                Q17_ROW_GROUPS and fired == agg.get("retries")) or any(
                c1[k] <= 0 for k in ("bucket_sum", "bucket_float_sum",
                                     "bucket_winner")) or [
                r[:2] + r[9:] for r in rows1] != [r[:2] + r[9:]
                                                  for r in rows0]:
            raise AssertionError(f"Q29a: stats {st}, {fired} faults, "
                                 f"launches {c1}")
        per_query["Q29a"] = c1
        emit({"query": "Q29a", "rows": n, "fault_spec": spec,
              "unfaulted_wall_ms": ms0, "wall_ms": ms1,
              "unfaulted_peak_bytes": peak0, "peak_bytes": peak1,
              "faults_fired": fired, "retry_stats": st,
              "rows_bitwise_equal": rows1 == rows0, "launches": c1})
    finally:
        shutil.rmtree(base_dir, ignore_errors=True)
        del t, strs

    # --- Q29b: the bench join under a real OOM -----------------------------
    fact, dim, want6, plan = bench_join(torch, np, dev, 1 << 23, DIM_ROWS)
    conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": "PALLAS",
                       **no_backoff})

    def q6(conf=conf):
        return sorted(_run(torch, plan(conf)[1], conf)[0])

    def q6_join():
        # the join alone, its output reduced on the card batch by batch:
        # under the cap only the probe holds memory that scales with it
        return _reduce_join(torch, plan(conf)[0])

    if q6() != want6:
        raise AssertionError("Q29b: Q6's rows differ from the oracle")
    # Q6 whole (the aggregate over the join) under AUTO (the fused plan)
    # and with both fused routes off: peak memory and route of each
    conf_off = RapidsConf({"spark.rapids.tpu.sql.join.strategy": "PALLAS",
                           **no_backoff, **FUSION_OFF})
    q6_peaks = {}
    for mode, cf in (("AUTO", conf), ("OFF", conf_off)):
        rows_m, ms_m, peak_m, c_m, _ = measured(lambda cf=cf: q6(cf))
        if rows_m != want6:
            raise AssertionError(f"Q29b: Q6 under {mode}: rows differ")
        q6_peaks[mode] = {"peak_bytes": peak_m, "wall_ms": ms_m,
                          "agg_route": c_m.agg_route}
    join0 = q6_join()
    rows0, ms0, peak0, c0, _ = measured(q6_join)
    if rows0 != join0 or rows0[0] != 1 << 23 or c0["probe_ranges"] != 1:
        raise AssertionError(f"Q29b unsplit: {rows0}, launches {c0}")
    total = torch.cuda.get_device_properties(0).total_memory
    tries = []
    found = None
    for f in Q29B_FACTORS:
        gc.collect()
        torch.cuda.empty_cache()
        cap = torch.cuda.memory_reserved() + int(f * peak0)
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            rows1, ms1, peak1, c1, st = measured(q6_join)
            outcome = None
        except (R.TpuOOMError, torch.cuda.OutOfMemoryError) as e:
            outcome = f"{type(e).__name__}: {str(e)[:200]}"
            st = R.stats()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        join = st.get("TpuShuffledHashJoinExec", {})
        tries.append({"factor": f, "cap_bytes": cap, "stats": st,
                      "error": outcome})
        if outcome is None and join.get("max_depth", 0) >= 1:
            if rows1 != rows0 or c1["probe_ranges"] < 2:
                raise AssertionError(f"Q29b: launches {c1}, stats {st}")
            found = (f, cap, rows1, ms1, peak1, c1, st)
            break
    gc.collect()
    torch.cuda.empty_cache()
    if found is None:
        raise AssertionError(f"Q29b: no cap split the probe: {tries}")
    f, cap, rows1, ms1, peak1, c1, st = found
    per_query["Q29b"] = c1
    emit({"query": "Q29b", "fact_rows": 1 << 23, "dim_rows": DIM_ROWS,
          "unsplit_wall_ms": ms0, "unsplit_peak_bytes": peak0,
          "factor": f, "cap_bytes": cap, "wall_ms": ms1, "peak_bytes": peak1,
          "retry_stats": st, "tries": tries, "q6_by_route": q6_peaks,
          "launches": c1})

    # --- Q29c: the build spilled to the host and brought back --------------
    # each run with a fresh catalog; a run with both fused routes off
    # first and last, so that neither route alone pays the allocator's
    # refill after Q29b's cap
    budget = 1 << 20
    walls = []
    off = {"wall_ms": []}
    for mode in ("OFF", "AUTO", "AUTO", "OFF"):
        try:
            cat = BufferCatalog.reset(RapidsConf(
                {"spark.rapids.tpu.memory.hbm.budgetBytes": budget}), dev)
            rows2, ms2, peak2, c2, _ = measured(
                q6 if mode == "AUTO" else lambda: q6(conf_off))
            spill = dict(vars(cat.metrics))
        finally:
            BufferCatalog.reset()
        # the build's two handles spill once each, at registration, and
        # come back once each for the probe, which holds them pinned: a
        # spill while the probe holds them would free nothing
        if rows2 != want6 or c2["probe_ranges"] != 1 or not (
                spill["device_to_host"] == 2 and spill["unspills"] == 2
                and spill["spilled_bytes"] >= DIM_ROWS * 18):
            raise AssertionError(f"Q29c: spill {spill}, launches {c2}")
        if mode == "OFF":
            off.update(peak_bytes=peak2, spill=spill,
                       agg_route=c2.agg_route)
            off["wall_ms"].append(ms2)
            continue
        walls.append(ms2)
        auto = (peak2, spill, c2)
    peak2, spill, c2 = auto
    per_query["Q29c"] = c2
    emit({"query": "Q29c", "budget_bytes": budget, "wall_ms": walls,
          "peak_bytes": peak2, "spill": spill, "fusion_off": off,
          "launches": c2})
    del fact, dim
    return per_query


# ---------------------------------------------------------------------------
# observability phase (Q20v-obs, Q22m-obs, Q29c-obs): each query with
# every observability key off, then on; the event log, the live plane and
# the device lane checked on the card
# ---------------------------------------------------------------------------
#: Q29c-obs's fact rows, as a power of two (Q6's), and its spill budget
#: (Q29c's)
Q29_FACT_LOG2_ROWS = 23
Q29C_BUDGET = 1 << 20
#: every observability key of the port on (the log's directory added per
#: query)
OBS_ON = {"spark.rapids.tpu.metrics.deviceSync.enabled": True,
          "spark.rapids.tpu.metrics.live.enabled": True,
          "spark.rapids.tpu.metrics.http.enabled": True,
          "spark.rapids.tpu.watchdog.enabled": True}


@contextlib.contextmanager
def plain_calls():
    """Count every call of a kernel module's ``*_plain`` version while
    the block runs (the kernels' wrappers reach them through the module
    globals). Yields the counts."""
    counts = {}
    saved = []
    for mod in _kernel_modules():
        for name, fn in list(vars(mod).items()):
            if name.endswith("_plain") and callable(fn):
                counts[name] = 0

                def counted(*a, _fn=fn, _name=name, **k):
                    counts[_name] += 1
                    return _fn(*a, **k)

                saved.append((mod, name, fn))
                setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _strategies_shown(plan, cls_name: str) -> set:
    """The ``strategy=X`` each ``cls_name`` exec of a plan shows in its
    ``describe()``."""
    import re

    return {m.group(1) for e in _device_tree(plan)
            if type(e).__name__ == cls_name
            for m in [re.search(r"strategy=(\w+)", e.describe())] if m}


def check_event_log(q: str, recs: list, root: str,
                    env: tuple) -> dict:
    """Hold one query's event log to the schema and to itself (see
    :func:`observability_phase`): ``env`` is the (backend, device kind)
    every ``query_start`` must carry (a kind of None is not checked);
    ``root`` the plan's root exec. Returns the counts by event type."""
    from collections import Counter

    from spark_rapids_tpu_torch import events as EV

    for r in recs:
        need = ("ts", "event", "tid") + EV.EVENT_TYPES[r["event"]]
        missing = [f for f in need if f not in r]
        if missing:
            raise AssertionError(f"{q}: {r['event']} lacks {missing}: {r}")
    starts = [r for r in recs if r["event"] == "query_start"]
    backend, kind = env
    if not starts or any(
            r["env"]["backend"] != backend
            or kind is not None and r["env"]["device_kind"] != kind
            for r in starts):
        raise AssertionError(f"{q}: query_start env {starts[:1]}")
    lanes = {}
    for r in recs:
        if r["event"] == "op_span":
            lanes.setdefault(r["op"], set()).add(r["lane"])
    batched = {r["op"] for r in recs if r["event"] == "op_batch"}
    if not batched or any(lanes.get(op) != {"host", "device"}
                          for op in batched):
        raise AssertionError(f"{q}: lanes by op {lanes}, batches by "
                             f"{sorted(batched)}")
    by_q = {}
    for r in recs:
        qid = r.get("query_id")
        if r["event"] in ("query_start", "query_end"):
            by_q.setdefault(qid, {})[r["event"]] = r
    # per query (its records lie between its start and end, on one
    # thread): the root's rows and the device lane's total time
    cur = None
    root_rows, dev_ns = Counter(), Counter()
    for r in recs:
        ev = r["event"]
        if ev == "query_start":
            cur = r["query_id"]
        elif ev == "query_end":
            cur = None
        elif cur is not None and ev == "op_batch" and r["op"] == root:
            root_rows[cur] += r["rows"]
        elif cur is not None and ev == "op_span" and r["lane"] == "device":
            dev_ns[cur] += r["dur"]
    for qid, se in by_q.items():
        end = se.get("query_end")
        if end is None or end["error"] or root_rows[qid] != end["rows"] \
                or dev_ns[qid] > end["dur"]:
            raise AssertionError(
                f"{q} query {qid}: end {end}, root rows {root_rows[qid]}, "
                f"device lane {dev_ns[qid]} ns")
    # the ledger: allocs, frees and bid-stamped spills add up to each
    # heap snapshot's live bytes
    size, on_dev = {}, set()
    for r in recs:
        ev = r["event"]
        if ev == "buffer_alloc" and r["kind"] != "reservation":
            size[r["bid"]] = r["bytes"]
            on_dev.add(r["bid"])
        elif ev == "buffer_free":
            size.pop(r["bid"], None)
            on_dev.discard(r["bid"])
        elif ev == "spill" and r.get("bid") in size:
            if r["kind"] == "device_to_host":
                on_dev.discard(r["bid"])
            elif r["kind"] == "unspill":
                on_dev.add(r["bid"])
        elif ev == "heap_snapshot":
            live = sum(size[b] for b in on_dev)
            if r["live_bytes"] != live or r["leaked"]:
                raise AssertionError(f"{q}: heap {r['live_bytes']} B "
                                     f"(leaked {r['leaked']}), the log's "
                                     f"allocs and frees {live} B")
    return dict(Counter(r["event"] for r in recs))


def observability_phase(torch, np, dev, smi: str) -> dict:
    """Q20v-obs, Q22m-obs and Q29c-obs (see the module docstring): each
    query's walls and launches with observability off and then on, the
    event log, the live plane and the device lane held to the checks of
    :func:`check_event_log` and the per-query ones below; ``smi`` (the
    card's name and power limit) goes on each query's line. Returns each
    path's launches (the logged runs')."""
    import gc
    import shutil
    import tempfile
    import urllib.request
    from collections import Counter

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import obs
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
    from spark_rapids_tpu_torch.sql import session as S

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, PARQUET_DIR)
    shutil.rmtree(base, ignore_errors=True)
    logs = tempfile.mkdtemp(prefix="srt_obs_")
    per_query = {}
    try:
        # --- the tables: Q20v's lineitem, Q22m's orders and customer, the
        # bench join's fact and dim --------------------------------------
        n = 1 << STRING_LOG2_ROWS
        t, want20, _, strs = lineitem_inputs(np, n)
        lpath = os.path.join(base, "lineitem_dict")
        os.makedirs(lpath)
        pq.write_table(pa.table({
            **{k: _pa_strings(pa, np, v) for k, v in strs.items()},
            "l_quantity": t["qty"], "l_extendedprice": t["price"],
            "l_discount": t["disc"], "l_tax": t["tax"],
            "l_shipdate": t["ship"]}), os.path.join(lpath, "t.parquet"),
            row_group_size=n // Q17_ROW_GROUPS)
        del t, strs
        n22 = 1 << ORDERS_LOG2_ROWS
        t22 = tpch_orders_customers(np, n22)
        chars = comment_chars(torch, t22, dev).cpu().numpy()
        opath = os.path.join(base, "orders")
        cpath = os.path.join(base, "customer")
        _write_files(pa, pq, opath, pa.table({
            "o_orderkey": t22["orderkey"], "o_custkey": t22["custkey"],
            "o_comment": _pa_strings(pa, np, (t22["offsets"], chars))}),
            MULTI_FILES)
        _write_files(pa, pq, cpath, pa.table({
            "c_custkey": t22["c_custkey"]}), 2)
        del chars
        want22 = q13_oracle(np, t22, like_oracle(np, t22))
        del t22
        nf = 1 << Q29_FACT_LOG2_ROWS
        fk, fv, dk, dv, want29 = bench_join_arrays(np, nf, DIM_ROWS)
        fpath = os.path.join(base, "fact")
        dpath = os.path.join(base, "dim")
        _write_files(pa, pq, fpath, pa.table({"fk": fk, "fv": fv}), 1)
        _write_files(pa, pq, dpath, pa.table({"dk": dk, "dv": dv}), 1)
        del fk, fv, dk, dv

        def q29(sess):
            return (sess.read.parquet(fpath)
                    .join(sess.read.parquet(dpath), [("fk", "dk")])
                    .group_by("fv")
                    .agg(A.agg(A.Sum(col("dv")), "s"),
                         A.agg(A.Count(None), "c"))
                    .order_by("fv"))

        def equal_to(want, q):
            def check(rows):
                if [tuple(r) for r in rows] != want:
                    raise AssertionError(f"{q}: rows differ from the "
                                         "oracle")
            return check

        vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
        pallas = {"spark.rapids.tpu.sql.join.strategy": "PALLAS"}
        # (path, confs, DataFrame of a session, check, kernels it launches)
        queries = [
            ("Q20v", vfa, lambda s: tpch_q1_df(np, s, lpath),
             lambda rows: tpch_q1_check(want20, rows, "Q20v-obs"),
             ("bucket_sum", "bucket_float_sum", "bucket_winner",
              "radix_segment_reduce")),
            ("Q22m", pallas,
             lambda s: tpch_q13_df(s, opath, cpath, _not_like),
             equal_to([tuple(r) for r in want22], "Q22m-obs"),
             ("probe_ranges", "bucket_sum")),
            ("Q29c", {**pallas,
                      "spark.rapids.tpu.memory.hbm.budgetBytes":
                      Q29C_BUDGET},
             q29, equal_to(want29, "Q29c-obs"), ("probe_ranges",)),
        ]
        env = ("gpu", torch.cuda.get_device_name(0)) if dev.type == "cuda" \
            else ("cpu", None)

        def fresh(settings):
            DeviceScanCache.reset()
            S._SCANNER_CACHE.clear()
            return S.TpuSession(settings, device=dev)

        def walls(q, sess, df_of, check):
            plans = []

            def run_once():
                rows = df_of(sess).collect()
                plans[:] = [sess.last_executed_plan]
                return rows

            with plain_calls() as plain:
                cold, warm, counts = _walls(torch, q, run_once, check)
            if dev.type == "cuda" and any(plain.values()):
                raise AssertionError(f"{q}: plain versions ran: {plain}")
            return cold, warm, counts, plans[0]

        # every query with observability off first: the live plane, once
        # started, stays up for the process until obs.shutdown()
        off = {}
        for q, settings, df_of, check, kernels in queries:
            off[q] = walls(f"{q}-obs off", fresh(settings), df_of, check)
            if not all(off[q][2][k] for k in kernels):
                raise AssertionError(f"{q}-obs off: launches {off[q][2]}")
        address = None
        for q, settings, df_of, check, kernels in queries:
            qdir = os.path.join(logs, q)
            # a fresh catalog (and ledger) for each logged query: the
            # earlier queries' buffers must not count in its heap
            gc.collect()
            BufferCatalog.reset(RapidsConf(settings), dev)
            sess = fresh({**settings, **OBS_ON,
                          "spark.rapids.tpu.eventLog.dir": qdir})
            spill0 = dict(vars(BufferCatalog.get().metrics))
            address = address or sess.obs_address
            try:
                cold, warm, counts, plan = walls(f"{q}-obs on", sess, df_of,
                                                 check)
                text = sess.explain_metrics()
                trace = sess.export_trace(os.path.join(logs, f"{q}.json"))
            finally:
                sess.close()
            spill1 = dict(vars(BufferCatalog.get().metrics))
            if counts != off[q][2] or counts.agg_route != off[q][2].agg_route:
                raise AssertionError(f"{q}-obs: launches on {counts} "
                                     f"({counts.agg_route}), off "
                                     f"{off[q][2]} ({off[q][2].agg_route})")
            if "opTimeDevice" not in text or "hbm_gbps[device]" not in text:
                raise AssertionError(f"{q}-obs: explain_metrics\n{text}")
            with open(trace) as f:
                tr = json.load(f)["traceEvents"]
            if not any(e.get("ph") == "X" for e in tr):
                raise AssertionError(f"{q}-obs: no span in the trace")
            (log,) = [os.path.join(qdir, f) for f in os.listdir(qdir)]
            with open(log) as f:
                recs = [json.loads(ln) for ln in f]
            root = plan.tpu_child.node_name
            events = check_event_log(q, recs, root, env)
            for ev, cls in (("agg_strategy", "TpuHashAggregateExec"),
                            ("join_strategy", "TpuShuffledHashJoinExec")):
                picked = {r["strategy"] for r in recs if r["event"] == ev}
                shown = _strategies_shown(plan.tpu_child, cls)
                if picked != shown:
                    raise AssertionError(f"{q}-obs: {ev} {picked}, "
                                         f"describe() {shown}")
            extra = {}
            if q == "Q22m":
                writes, fetches = Counter(), Counter()
                for r in recs:
                    key = (r.get("shuffle_id"), r.get("reduce_id"))
                    if r["event"] == "shuffle_write":
                        writes[key] += r["rows"]
                    elif r["event"] == "shuffle_fetch":
                        fetches[key] += r["rows"]
                if not writes or +writes != +fetches:
                    raise AssertionError(f"{q}-obs: shuffle rows written "
                                         f"{sum(writes.values())}, fetched "
                                         f"{sum(fetches.values())}")
                extra["shuffle_rows"] = sum(writes.values())
            if q == "Q29c":
                kinds = Counter(r["kind"] for r in recs
                                if r["event"] == "spill")
                spilled = sum(r["bytes"] for r in recs
                              if r["event"] == "spill"
                              and r["kind"] == "device_to_host")
                delta = {k: spill1[k] - spill0[k] for k in spill1}
                if not (kinds["device_to_host"] and kinds["unspill"]) or (
                        kinds["device_to_host"], kinds["unspill"],
                        kinds["host_to_disk"], spilled) != (
                        delta["device_to_host"], delta["unspills"],
                        delta["host_to_disk"], delta["spilled_bytes"]):
                    raise AssertionError(f"{q}-obs: spill events {kinds} "
                                         f"({spilled} B), catalog {delta}")
                extra["spills"] = delta
            per_query[f"{q}-obs"] = counts
            emit({"query": f"{q}-obs", "card": smi,
                  "off": {"cold_wall_ms": off[q][0],
                          "warm_wall_ms": off[q][1]},
                  "on": {"cold_wall_ms": cold, "warm_wall_ms": warm},
                  "launches": counts, "agg_route": counts.agg_route,
                  "events": events, **extra})
        with urllib.request.urlopen(address + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(address + "/status", timeout=30) as r:
            status = json.loads(r.read())
        for fam in ("tpu_agg_strategy_total{", "tpu_join_strategy_total{"):
            if fam not in metrics:
                raise AssertionError(f"/metrics lacks {fam}")
        if status["env"]["backend"] != env[0] or status["queries_live"]:
            raise AssertionError(f"/status: {status['env']}, "
                                 f"{status['queries_live']} live")
        emit({"obs_plane": address,
              "strategy_lines": [ln for ln in metrics.splitlines()
                                 if ln.startswith(("tpu_agg_strategy_total",
                                                   "tpu_join_strategy_total"))],
              "status_queries": len(status["queries"]),
              "alerts": status["alerts"]})
    finally:
        obs.shutdown()
        BufferCatalog.reset()
        shutil.rmtree(base, ignore_errors=True)
        shutil.rmtree(logs, ignore_errors=True)
    return per_query


# ---------------------------------------------------------------------------
# mesh phase: bench.py's six mesh shapes over 4 shards of one card
# ---------------------------------------------------------------------------
#: shards of the mesh phase (virtual devices laid over the one card)
MESH_SHARDS = 4
MESH_BASE = {"spark.rapids.tpu.shuffle.mode": "ici",
             "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
             "spark.rapids.tpu.mesh.devices": MESH_SHARDS}
MESH_HOST = {"spark.rapids.tpu.shuffle.mode": "host",
             "spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
#: the mesh shapes' rows (bench.py's at scale 1), as powers of two: the
#: agg shapes, the sort/join/window/parquet shapes, the string shape
MESH_AGG_LOG2_ROWS = 26
MESH_LOG2_ROWS = 23
MESH_STRING_LOG2_ROWS = 22


def np_shard_parts(np, arrays, masks, n: int, n_parts: int):
    """bench.py's ``_np_shard_parts``: the columns split into ``n_parts``
    contiguous chunks of (data, valid)."""
    per = (n + n_parts - 1) // n_parts
    parts = []
    for p in range(n_parts):
        lo, hi = p * per, min((p + 1) * per, n)
        parts.append(([(x[lo:hi], np.ones(hi - lo, bool) if m is None
                        else m[lo:hi]) for x, m in zip(arrays, masks)],
                      hi - lo))
    return parts


def plan_columns(torch, root):
    """Every output column's live rows over all partitions on the card,
    as (data with nulls zeroed, validity) pairs."""
    cols = [[] for _ in root.output_schema.fields]
    for p in range(root.num_partitions):
        for b in root.execute_partition(p):
            n = int(b.num_rows)
            for j, c in enumerate(b.columns):
                v = c.validity[:n]
                cols[j].append((torch.where(v, c.data[:n],
                                            torch.zeros_like(c.data[:n])), v))
    return [(torch.cat([d for d, _ in ps]), torch.cat([v for _, v in ps]))
            for ps in cols]


def sorted_rows(torch, cols):
    """The columns' rows in lexicographic order (nulls as 0 beside their
    validity): the multiset of rows, comparable across plans."""
    keys = [w for d, v in cols for w in (v.to(torch.int64), d)]
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return [(d[perm], v[perm]) for d, v in cols]


def same_columns(torch, what, got, want, exact=True):
    """The same rows column by column, bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} != {len(want)} columns")
    for j, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        if gd.numel() != wd.numel() or not torch.equal(gv, wv) or not (
                torch.equal(gd, wd)):
            raise AssertionError(f"{what}: column {j} differs")


def mesh_stage_report(root) -> list:
    """Each mesh stage of a device plan: its description, shards and
    staging/exchange actuals."""
    from spark_rapids_tpu_torch.exec.mesh import _MeshStage

    out = []
    for e in _device_tree(root):
        if isinstance(e, _MeshStage):
            out.append({"stage": e.describe(), "shards": e.n_shards,
                        "devices": [str(d) for d in e.devices],
                        **{k: v for k, v in e.mesh_actuals.items()
                           if k != "per_chip_ns"},
                        "per_chip_ms": [round(x / 1e6, 3) for x in
                                        e.mesh_actuals.get("per_chip_ns",
                                                           [])]})
    return out


def mesh_query(torch, q: str, mesh_run, host_run, compare, rows: int,
               nbytes: int, need=()) -> dict:
    """One mesh shape: the mesh plan's cold and two warm walls (launch
    counts set to 0 before each run and read after, every run repeating
    the first's, no plain version called), its stages; the port's
    host-exchange plan of the same query once (its wall), and
    ``compare(mesh result, host result)``. ``need``: the kernels that
    must launch on the mesh path. Returns the launches."""
    results = []

    def run_once():
        res, root = mesh_run()
        results[:] = [(res, root)]
        return res

    with plain_calls() as plain:
        cold, warm, counts = _walls(torch, q, run_once, lambda r: None,
                                    runs=3)
    if any(plain.values()):
        raise AssertionError(f"{q}: plain versions called on the card: "
                             f"{plain}")
    res, root = results[0]
    stages = mesh_stage_report(root)
    if not stages or any(s["shards"] != MESH_SHARDS for s in stages):
        raise AssertionError(f"{q}: mesh stages {stages}")
    missing = [k for k in need if not counts[k]]
    if missing:
        raise AssertionError(f"{q}: {missing} did not launch: {counts}")
    reset_launches()
    t0 = time.perf_counter()
    want = host_run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    compare(res, want)
    emit({"query": q, "rows": rows, "cold_wall_ms": cold,
          "warm_wall_ms": warm, "host_exchange_wall_ms": host_ms,
          "bytes": nbytes, "bound_ms": bound_ms(nbytes), "launches": counts,
          "stages": stages})
    return counts


def _mesh_agg_shape(np, n: int):
    """bench.py ``mesh_shape_agg`` (seed 42): k in [0, 64), a, b ~ N(0, 1)
    with 5% nulls."""
    rng = np.random.default_rng(42)
    k = rng.integers(0, 64, n).astype(np.int32)
    a = rng.integers(-(10**6), 10**6, n).astype(np.int64)
    b = rng.normal(size=n)
    b_null = rng.random(n) < 0.05
    return k, a, np.where(b_null, 0.0, b), ~b_null


def mesh_phase(torch, np, dev) -> dict:
    """bench.py's six mesh shapes (``bench.py:731-925``) at scale 1 under
    ``shuffle.mode=ici`` over a mesh of 4 virtual devices on the one card
    (``SRTPU_TORCH_VIRTUAL_DEVICES=4``, ``mesh.devices=4``,
    ``variableFloatAgg`` as the bench's mesh lane sets it), each against
    the port's host-exchange plan of the same query on the card, and one
    partitioned query under ``shuffle.transport.class=network``:

      M-agg    2^26 rows from the sharded scan -> filter a >= 0 -> project
               a2 = a*2 -> mesh aggregate by k: sum(a2), avg(b),
               count(b) (the chain absorbed per shard); K1 and K2 must
               launch; M-aggm the same chain with min(a2), max(b): K3;
      M-sort   2^23 int64 keys, the sampled range exchange;
      M-join   2^23 fact rows x 100 000 dim rows, inner, on fk = dk;
      M-window 2^23 rows, sum(v) and row_number() over (partition by k
               order by ts);
      M-string 2^22 rows of the bench string pool (dictionary layout,
               materialized at staging), filter contains(s, "X"), group by
               s: count(*), sum(v); string keys take the RADIX kernel;
      M-parquet bench.py ``shape_parquet`` through a session: 2^23 rows in
               8 row groups round-robined onto the shards; K1 and K2;
      M-net    M-parquet's query under the single-process exchange with
               ``transport.class=network`` (a local block server) against
               the ``host`` transport.

    Integer columns must equal the host plan's bit for bit (rows as
    multisets; M-sort's key sequence in order); float sums and averages
    within 1e-9 of each group's sum of |x| (the kernels' atomics order
    them)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec, TpuFilterExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.exec.join import TpuShuffledHashJoinExec
    from spark_rapids_tpu_torch.exec.mesh import (TpuMeshAggregateExec,
                                                  TpuMeshHashJoinExec,
                                                  TpuMeshSortExec,
                                                  TpuMeshWindowExec)
    from spark_rapids_tpu_torch.exec.scan import MeshShardedScanExec
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    from spark_rapids_tpu_torch.exec.window import TpuWindowExec
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr import windows as W
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    from spark_rapids_tpu_torch.ops.sort import SortOrder
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.shuffle.partition import (HashPartitioning,
                                                          RangePartitioning)

    saved = os.environ.get(PM.VIRTUAL_DEVICES_ENV)
    os.environ[PM.VIRTUAL_DEVICES_ENV] = str(MESH_SHARDS)
    conf = RapidsConf(MESH_BASE)
    hconf = RapidsConf(MESH_HOST)
    per_query = {}

    def hash_ex(child, keys):
        return TpuShuffleExchangeExec(hconf, child,
                                      HashPartitioning(keys, MESH_SHARDS))

    def two_phase(scan_of, chain, keys, aggs):
        """partial -> hash exchange -> final over ``chain(scan)``: the
        planner's host route."""
        partial = TpuHashAggregateExec(hconf, keys, aggs, chain(scan_of()),
                                       A.PARTIAL)
        return TpuHashAggregateExec(hconf, keys, aggs,
                                    hash_ex(partial, list(range(len(keys)))),
                                    A.FINAL)

    def agg_rows(root):
        return sorted(ColumnarToRowExec(conf, root).collect(),
                      key=lambda r: (r[0] is None, r[0]))

    from spark_rapids_tpu_torch.exec import ColumnarToRowExec

    try:
        # M-agg, M-aggm ------------------------------------------------
        n = 1 << MESH_AGG_LOG2_ROWS
        k, a, b, bv = _mesh_agg_shape(np, n)
        schema = schema_of(k=T.INT, a=T.LONG, b=T.DOUBLE)
        parts = np_shard_parts(np, [k, a, b], [None, None, bv], n,
                               MESH_SHARDS)
        keep = a >= 0
        abs_b = np.bincount(k[keep & bv], weights=np.abs(b[keep & bv]),
                            minlength=64)
        cnt_b = np.bincount(k[keep & bv], minlength=64)

        def chain(scan):
            filt = TpuFilterExec(scan.conf, E.GreaterThanOrEqual(
                col("a"), lit(0)), scan)
            return TpuProjectExec(scan.conf, [
                col("k"), E.Alias(E.Multiply(col("a"), lit(2)), "a2"),
                col("b")], filt)

        for q, aggs, need, fcols in (
                ("M-agg", [A.agg(A.Sum(col("a2")), "s"),
                           A.agg(A.Average(col("b")), "m"),
                           A.agg(A.Count(col("b")), "c")],
                 ("bucket_sum", "bucket_float_sum"), {2: "avg"}),
                ("M-aggm", [A.agg(A.Min(col("a2")), "mn"),
                            A.agg(A.Max(col("b")), "mx"),
                            A.agg(A.Count(col("b")), "c")],
                 ("bucket_winner",), {})):
            def mesh_run(aggs=aggs):
                root = TpuMeshAggregateExec(
                    conf, [col("k")], aggs,
                    chain(MeshShardedScanExec(conf, parts, schema, dev)))
                return agg_rows(root), root

            def host_run(aggs=aggs):
                return agg_rows(two_phase(
                    lambda: MeshShardedScanExec(hconf, parts, schema, dev),
                    chain, [col("k")], aggs))

            def compare(got, want, q=q, fcols=fcols):
                if len(got) != len(want) or len(got) != 64:
                    raise AssertionError(f"{q}: {len(got)} groups")
                for g, w in zip(got, want):
                    for j, (x, y) in enumerate(zip(g, w)):
                        if j in fcols:
                            kk = g[0]
                            if not _close(x, y, abs_b[kk] / max(
                                    cnt_b[kk], 1)):
                                raise AssertionError(f"{q} {g} != {w}")
                        elif x != y:
                            raise AssertionError(f"{q} {g} != {w}")

            per_query[q] = mesh_query(torch, q, mesh_run, host_run, compare,
                                      n, n * 22, need)
        del parts, k, a, b, bv

        # M-sort --------------------------------------------------------
        n = 1 << MESH_LOG2_ROWS
        rng = np.random.default_rng(7)
        key = rng.integers(-(2**40), 2**40, n)
        pay = rng.integers(0, 1000, n).astype(np.int32)
        schema = schema_of(key=T.LONG, pay=T.INT)
        parts = np_shard_parts(np, [key, pay], [None, None], n, MESH_SHARDS)

        def sort_compare(got, want):
            if not torch.equal(got[0][0], want[0][0]):
                raise AssertionError("M-sort: key order differs")
            same_columns(torch, "M-sort", sorted_rows(torch, got),
                         sorted_rows(torch, want))

        per_query["M-sort"] = mesh_query(
            torch, "M-sort",
            lambda: (lambda r: (plan_columns(torch, r), r))(TpuMeshSortExec(
                conf, [0], [(True, True)],
                MeshShardedScanExec(conf, parts, schema, dev))),
            lambda: plan_columns(torch, TpuSortExec(
                hconf, [col("key")], [(True, True)], TpuShuffleExchangeExec(
                    hconf, MeshShardedScanExec(hconf, parts, schema, dev),
                    RangePartitioning([0], [SortOrder(True, True)],
                                      MESH_SHARDS)), global_sort=False)),
            sort_compare, n, n * 12 * 2)
        del parts, key, pay

        # M-join --------------------------------------------------------
        d = DIM_ROWS
        rng = np.random.default_rng(11)
        fk = rng.integers(0, d, n).astype(np.int64)
        fv = rng.integers(0, 100, n).astype(np.int64)
        dk = np.arange(d, dtype=np.int64)
        dv = rng.integers(0, 10**6, d).astype(np.int64)
        fs, ds = schema_of(fk=T.LONG, fv=T.LONG), schema_of(dk=T.LONG,
                                                           dv=T.LONG)
        fparts = np_shard_parts(np, [fk, fv], [None, None], n, MESH_SHARDS)
        dparts = np_shard_parts(np, [dk, dv], [None, None], d, MESH_SHARDS)

        def multiset(q):
            return lambda got, want: same_columns(
                torch, q, sorted_rows(torch, got), sorted_rows(torch, want))

        per_query["M-join"] = mesh_query(
            torch, "M-join",
            lambda: (lambda r: (plan_columns(torch, r), r))(
                TpuMeshHashJoinExec(
                    conf, MeshShardedScanExec(conf, fparts, fs, dev),
                    MeshShardedScanExec(conf, dparts, ds, dev), [0], [0])),
            lambda: plan_columns(torch, TpuShuffledHashJoinExec(
                hconf,
                hash_ex(MeshShardedScanExec(hconf, fparts, fs, dev), [0]),
                hash_ex(MeshShardedScanExec(hconf, dparts, ds, dev), [0]),
                [col("fk")], [col("dk")], "inner", None, partitioned=True)),
            multiset("M-join"), n, (n + d) * 16 + n * 32)
        del fparts, dparts, fk, fv

        # M-window ------------------------------------------------------
        rng = np.random.default_rng(13)
        wk = rng.integers(0, 64, n).astype(np.int32)
        ts = rng.permutation(n).astype(np.int64)
        wv = rng.integers(0, 1000, n).astype(np.int64)
        schema = schema_of(k=T.INT, ts=T.LONG, v=T.LONG)
        parts = np_shard_parts(np, [wk, ts, wv], [None] * 3, n, MESH_SHARDS)
        spec = W.WindowSpec(partition_by=(col("k"),), order_by=(col("ts"),),
                            orders=((True, True),))
        wexprs = [W.WindowExpression(A.Sum(col("v")), spec, "rs"),
                  W.WindowExpression(W.RowNumber(), spec, "rn")]
        per_query["M-window"] = mesh_query(
            torch, "M-window",
            lambda: (lambda r: (plan_columns(torch, r), r))(
                TpuMeshWindowExec(conf, wexprs, MeshShardedScanExec(
                    conf, parts, schema, dev))),
            lambda: plan_columns(torch, TpuWindowExec(
                hconf, wexprs, MeshShardedScanExec(hconf, parts, schema,
                                                   dev))),
            multiset("M-window"), n, n * 20 * 2)
        del parts, wk, ts, wv

        # M-string ------------------------------------------------------
        n = 1 << MESH_STRING_LOG2_ROWS
        idx, sv, _, _ = string_pool_rows(np, n)
        schema = schema_of(s=T.STRING, v=T.LONG)
        per = n // MESH_SHARDS
        partitions = []
        for p in range(MESH_SHARDS):
            lo, hi = p * per, (p + 1) * per
            vb = _padded_batch(np, torch, schema_of(v=T.LONG), [sv[lo:hi]],
                               [np.ones(hi - lo, bool)], dev)
            partitions.append([ColumnarBatch(
                [pool_dict_column(np, dev, STRING_POOL, idx[lo:hi]),
                 vb.columns[0]], schema, hi - lo)])
        sagg = [A.agg(A.Count(None), "c"), A.agg(A.Sum(col("v")), "sv")]

        def sfilt(scan):
            return TpuFilterExec(scan.conf, E.Contains(col("s"), lit("X")),
                                 scan)

        def sscan(c):
            return InMemoryScanExec(c, partitions, schema)

        def exact(q):
            def check(got, want):
                if got != want or not got:
                    raise AssertionError(f"{q}: {got} != {want}")
            return check

        per_query["M-string"] = mesh_query(
            torch, "M-string",
            lambda: (lambda r: (agg_rows(r), r))(TpuMeshAggregateExec(
                conf, [col("s")], sagg, sfilt(sscan(conf)))),
            lambda: agg_rows(two_phase(lambda: sscan(hconf), sfilt,
                                       [col("s")], sagg)),
            exact("M-string"), n, n * 13, ("radix_segment_reduce",))
        del partitions

        # M-parquet, M-net ----------------------------------------------
        import pyarrow as pa
        import pyarrow.parquet as pq
        from spark_rapids_tpu_torch.sql import TpuSession

        n = 1 << MESH_LOG2_ROWS
        item, qty, cost, date = bench_parquet_table(np, n)
        pdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            PARQUET_DIR, "mesh")
        os.makedirs(pdir, exist_ok=True)
        path = os.path.join(pdir, "t.parquet")
        pq.write_table(pa.table({
            "ss_item_sk": item, "ss_quantity": qty,
            "ss_wholesale_cost": cost, "ss_sold_date_sk": date}), path,
            row_group_size=n // (2 * MESH_SHARDS))
        q11 = q11_check(np, qty, cost, date)
        # one split per row group (bench.py's batchSizeBytes=1)
        split = {"spark.rapids.tpu.sql.reader.batchSizeBytes": 1}

        def pq_rows(settings):
            sess = TpuSession({**settings, **split}, device=dev)
            df = (sess.read.parquet(pdir)
                  .where(E.GreaterThanOrEqual(col("ss_sold_date_sk"),
                                              lit(2_452_015)))
                  .group_by("ss_quantity")
                  .agg(A.agg(A.Sum(col("ss_wholesale_cost")), "s"),
                       A.agg(A.Count(col("ss_item_sk")), "c")))
            return sorted(df.collect()), sess.last_executed_plan.tpu_child

        def q11_compare(q):
            def check(got, want):
                q11(got, q)
                q11(want, q + " (host)")
                for g, w in zip(got, want):
                    if g[0] != w[0] or g[2] != w[2]:
                        raise AssertionError(f"{q}: {g} != {w}")
            return check

        try:
            per_query["M-parquet"] = mesh_query(
                torch, "M-parquet", lambda: pq_rows(MESH_BASE),
                lambda: pq_rows(MESH_HOST)[0], q11_compare("M-parquet"), n,
                n * 12, ("bucket_sum", "bucket_float_sum"))
            net = {**MESH_HOST,
                   "spark.rapids.tpu.shuffle.transport.class": "network"}
            reset_launches()
            t0 = time.perf_counter()
            got, plan = pq_rows(net)
            net_ms = (time.perf_counter() - t0) * 1e3
            per_query["M-net"] = launches()
            want, _ = pq_rows({**MESH_HOST,
                               "spark.rapids.tpu.shuffle.transport.class":
                               "host"})
            q11_compare("M-net")(got, want)
            xs = exchange_report(plan)
            if not xs or not all(x["shuffleBytesFetched"] for x in xs):
                raise AssertionError(f"M-net: exchanges {xs}")
            emit({"query": "M-net", "rows": n, "wall_ms": net_ms,
                  "launches": per_query["M-net"], "exchanges": xs})
        finally:
            import shutil

            from spark_rapids_tpu_torch.shuffle.network import (
                shutdown_local_server)

            shutdown_local_server()
            shutil.rmtree(pdir, ignore_errors=True)
    finally:
        if saved is None:
            os.environ.pop(PM.VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[PM.VIRTUAL_DEVICES_ENV] = saved
    return per_query


# ---------------------------------------------------------------------------
# serve phase (S-solo, S-mix, S-reject): Q11, Q20v, Q18m and Q25 through the
# serving scheduler (serve/), one session a query
# ---------------------------------------------------------------------------
#: serving on, with the event log's ring (the admission records and the
#: ledger, which arms with it)
SERVE_ON = {"spark.rapids.tpu.serve.enabled": True,
            "spark.rapids.tpu.eventLog.enabled": True}
#: S-mix: submissions of each session's query, the sessions' queue
#: timeout, the threads' join timeout (s) and the priority session
SERVE_REPEATS = 3
SERVE_QUEUE_TIMEOUT_MS = 120_000
SERVE_JOIN_S = 300
SERVE_PRIORITY_QUERY = "Q18m"
#: the kernels each query must launch alone (its phase's own check)
SERVE_KERNELS = {"Q11": ("bucket_sum", "bucket_float_sum"),
                 "Q20v": ("bucket_sum", "bucket_float_sum", "bucket_winner"),
                 "Q18m": ("probe_ranges",),
                 "Q25": ("probe_ranges", "radix_segment_reduce")}
#: K1-K4, which S-mix must launch
SERVE_MIX_KERNELS = ("bucket_sum", "bucket_float_sum", "bucket_winner",
                     "probe_ranges")


def serve_queries(np, pa, pq, base: str) -> tuple:
    """Q11's, Q20v's, Q18m's and Q25's files written again under ``base``
    from their phases' seeds, at their full sizes. Returns ({query:
    (settings, DataFrame of a session, check(rows, what))}, seconds spent
    writing)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    vfa = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    pallas = {"spark.rapids.tpu.sql.join.strategy": "PALLAS"}
    t0 = time.perf_counter()
    # Q11: the bench parquet table, one file of 2^21-row row groups
    n = 1 << PARQUET_LOG2_ROWS
    item, qty, cost, date = bench_parquet_table(np, n)
    spath = os.path.join(base, "store_sales")
    os.makedirs(spath)
    pq.write_table(pa.table({
        "ss_item_sk": item, "ss_quantity": qty,
        "ss_wholesale_cost": cost, "ss_sold_date_sk": date}),
        os.path.join(spath, "t.parquet"), row_group_size=1 << 21)
    check11 = q11_check(np, qty, cost, date)
    del item, qty, cost, date

    def q11(sess):
        return (sess.read.parquet(spath)
                .where(E.GreaterThanOrEqual(col("ss_sold_date_sk"),
                                            lit(2_452_015)))
                .group_by("ss_quantity")
                .agg(A.agg(A.Sum(col("ss_wholesale_cost")), "s"),
                     A.agg(A.Count(col("ss_item_sk")), "c")))

    # Q20v: TPC-H Q1 over one pyarrow-default (dictionary) file
    n = 1 << STRING_LOG2_ROWS
    t, want20, _, strs = lineitem_inputs(np, n)
    lpath = os.path.join(base, "lineitem_dict")
    os.makedirs(lpath)
    pq.write_table(pa.table({
        **{k: _pa_strings(pa, np, v) for k, v in strs.items()},
        "l_quantity": t["qty"], "l_extendedprice": t["price"],
        "l_discount": t["disc"], "l_tax": t["tax"],
        "l_shipdate": t["ship"]}), os.path.join(lpath, "t.parquet"),
        row_group_size=n // Q17_ROW_GROUPS)
    del t, strs
    # Q18m: the zip join, fact as MULTI_FILES files, the dim broadcast
    fpath, dpath, want18, _ = q18m_write(np, pa, pq, base)
    # Q25: TPC-DS q5's store channel over the sales tables
    t = store_sales_table(np, 1 << SALES_LOG2_ROWS)
    tables = tpcds_sales_tables(pa, np, t)
    paths = {k: os.path.join(base, k + "_25") for k in tables}
    _write_files(pa, pq, paths["store_sales"], tables["store_sales"],
                 MULTI_FILES, store_decimal_as_integer=True)
    for k in ("date_dim", "store"):
        _write_files(pa, pq, paths[k], tables[k], 1)
    want25 = q25_oracle(np, t)
    del t, tables

    def check25(rows, what):
        if rows != want25:
            raise AssertionError(f"{what}: {rows[:3]} != {want25[:3]}")

    queries = {
        "Q11": (vfa, q11, check11),
        "Q20v": (vfa, lambda s: tpch_q1_df(np, s, lpath),
                 lambda rows, what: tpch_q1_check(want20, rows, what)),
        "Q18m": ({**vfa, **pallas}, lambda s: q18m_df(s, fpath, dpath),
                 lambda rows, what: q18m_check(want18, rows, what)),
        "Q25": (pallas, lambda s: q25_df(s, paths, E, A, T), check25),
    }
    return queries, time.perf_counter() - t0


def serve_phase(torch, np, dev, smi: str) -> dict:
    """S-solo, S-mix and S-reject (see the module docstring): the four
    queries alone through a serving session each (their launches, the
    analyzer's forecast beside the measured peak and the ledger's
    observed peak), then on four sessions on four threads under a budget
    that cannot hold the two largest forecasts at once, then one refused
    outright. Returns each path's launches."""
    import shutil
    import threading
    import traceback
    import urllib.request

    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import obs
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
    from spark_rapids_tpu_torch.serve import (QueryScheduler,
                                              ServeAdmissionRejected,
                                              SharedPlanCache)
    from spark_rapids_tpu_torch.sql import session as S

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, PARQUET_DIR)
    shutil.rmtree(base, ignore_errors=True)
    per_query = {}

    def admissions(sessions):
        """Every admission record of ``sessions``' rings (the scheduler
        emits into whichever session's log is the active sink)."""
        recs = [r for s in sessions for r in s.events.records()
                if r["event"] == "admission"]
        return sorted(recs, key=lambda r: r["ts"])

    try:
        queries, write_s = serve_queries(np, pa, pq, base)
        emit({"table": "serve", "queries": list(queries),
              "write_s": write_s})

        # --- S-solo: each query alone, cold ------------------------------
        QueryScheduler.reset()
        SharedPlanCache.reset()
        solo = {}
        with plain_calls() as plain:
            for q, (settings, df_of, check) in queries.items():
                DeviceScanCache.reset()
                S._SCANNER_CACHE.clear()
                sess = S.TpuSession({**settings, **SERVE_ON}, device=dev)
                try:
                    df = df_of(sess)
                    torch.cuda.synchronize()
                    mem0 = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    reset_launches()
                    t0 = time.perf_counter()
                    rows = df.collect()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                    counts = launches()
                    measured = torch.cuda.max_memory_allocated(dev) - mem0
                    check(rows, f"S-solo {q}")
                    an = sess.last_analysis
                    ledger = BufferCatalog.get().ledger.observed_peak(
                        sess._last_digest)
                    (adm,) = admissions([sess])
                finally:
                    sess.close()
                if not all(counts[k] for k in SERVE_KERNELS[q]):
                    raise AssertionError(f"S-solo {q}: launches {counts}")
                forecast = an.peak_hbm if an is not None else None
                solo[q] = {"wall_ms": wall, "peak_hbm": forecast,
                           "measured_peak_bytes": measured,
                           "ledger_peak": ledger, "launches": counts}
                per_query[f"S-{q}"] = counts
                emit({"query": f"S-{q}", "card": smi, "wall_ms": wall,
                      "launches": counts, "peak_hbm_forecast": forecast,
                      "bounded": an.bounded if an is not None else None,
                      "measured_peak_bytes": measured,
                      "ledger_observed_peak": ledger,
                      "forecast_below_measured": (
                          forecast is not None and forecast < measured),
                      "admission": {k: adm[k] for k in (
                          "verdict", "forecast_bytes", "forecast_source")}})
        if dev.type == "cuda" and any(plain.values()):
            raise AssertionError(f"S-solo: plain versions ran: {plain}")

        # --- S-mix: four sessions, four threads, a budget too small for
        # the two largest forecasts at once ----------------------------
        # a session's first submission is admitted on the analyzer's
        # forecast (the mix's catalog, and so its ledger, is new), later
        # ones on the ledger's observed peak of that first run
        top = sorted(((max(v for v in (s["peak_hbm"], s["ledger_peak"])
                           if v is not None), q)
                      for q, s in solo.items()
                      if s["peak_hbm"] is not None
                      or s["ledger_peak"] is not None), reverse=True)
        if len(top) < 2:
            raise AssertionError(f"S-mix: fewer than two forecasts: {solo}")
        budget = top[0][0] + top[1][0] // 2
        mix = {}
        for q, (settings, _, _) in queries.items():
            mix[q] = {**settings, **SERVE_ON,
                      "spark.rapids.tpu.metrics.http.enabled": True,
                      "spark.rapids.tpu.memory.hbm.budgetBytes": budget,
                      "spark.rapids.tpu.serve.queueTimeoutMs":
                      SERVE_QUEUE_TIMEOUT_MS}
            if q == SERVE_PRIORITY_QUERY:
                mix[q]["spark.rapids.tpu.serve.priority"] = 1
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        # sessions made here, on one thread: the first resets the
        # catalog to the budget, the others find it so
        sessions = {q: S.TpuSession(mix[q], device=dev) for q in queries}
        name = {s.serve_id: q for q, s in sessions.items()}
        address = sessions["Q11"].obs_address
        sched = QueryScheduler.reset()
        SharedPlanCache.reset()
        barrier = threading.Barrier(len(queries))
        errors = []
        walls = {q: [] for q in queries}

        def worker(q):
            sess = sessions[q]
            _, df_of, check = queries[q]
            try:
                barrier.wait(60)
                for i in range(SERVE_REPEATS):
                    t0 = time.perf_counter()
                    rows = df_of(sess).collect()
                    walls[q].append((time.perf_counter() - t0) * 1e3)
                    check(rows, f"S-mix {q} run {i}")
            except Exception:  # reported by the main thread
                errors.append((q, traceback.format_exc()))

        status_serve = None
        with plain_calls() as plain:
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            threads = [threading.Thread(target=worker, args=(q,),
                                        name=f"serve-{q}", daemon=True)
                       for q in queries]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            # /status once while a ticket waits (the exporter's thread
            # reads the scheduler as tpu_top does)
            while any(th.is_alive() for th in threads) and \
                    time.perf_counter() - t0 < SERVE_JOIN_S:
                if status_serve is None and sched.stats()["waiting"]:
                    with urllib.request.urlopen(address + "/status",
                                                timeout=30) as r:
                        st = json.loads(r.read())
                    if st["serve"] and st["serve"]["queue"]:
                        status_serve = st["serve"]
                        status_reserved = st["hbm"]["reserved_bytes"]
                time.sleep(0.002)
            for th in threads:
                th.join(max(1.0, SERVE_JOIN_S - (time.perf_counter() - t0)))
            torch.cuda.synchronize()
            makespan = (time.perf_counter() - t0) * 1e3
            counts = launches()
            measured = torch.cuda.max_memory_allocated(dev) - mem0
        wedged = [th.name for th in threads if th.is_alive()]
        if wedged:
            raise AssertionError(f"S-mix: threads still running after "
                                 f"{SERVE_JOIN_S} s: {wedged}, "
                                 f"{sched.stats()}, {sched.queue_status()}")
        if errors:
            raise AssertionError(f"S-mix failed: {errors}")
        if dev.type == "cuda" and any(plain.values()):
            raise AssertionError(f"S-mix: plain versions ran: {plain}")
        stats = sched.stats()
        recs = admissions(sessions.values())
        tickets = [{"query": name.get(r["session"], r["session"]),
                    "verdict": r["verdict"],
                    "forecast_bytes": r["forecast_bytes"],
                    "forecast_source": r["forecast_source"]} for r in recs]
        cat = BufferCatalog.get()
        for s in sessions.values():
            s.close()
        want = {k: SERVE_REPEATS * sum(s["launches"][k]
                                       for s in solo.values())
                for k in counts}
        if dict(counts) != want or not all(counts[k]
                                           for k in SERVE_MIX_KERNELS):
            raise AssertionError(f"S-mix launches {dict(counts)}, 3x the "
                                 f"solo sums {want}")
        admits = sum(t["verdict"] == "admit" for t in tickets)
        if (stats["admitted"] != SERVE_REPEATS * len(queries)
                or admits != stats["admitted"] or not stats["queued"]
                or not any(t["verdict"] == "queue" for t in tickets)
                or stats["rejected"] or stats["timeouts"]
                or stats["active"] or stats["waiting"]
                or cat.reserved_bytes):
            raise AssertionError(f"S-mix: stats {stats}, reserved "
                                 f"{cat.reserved_bytes} B, tickets "
                                 f"{tickets}")
        if not stats["bypass_admissions"] and \
                stats["peak_inflight_forecast"] > budget:
            raise AssertionError(f"S-mix admitted past the budget: {stats}")
        if status_serve is None:
            raise AssertionError("S-mix: /status never showed a waiting "
                                 "query")
        waiting = [name.get(w["session"], w["session"])
                   for w in status_serve["queue"]]
        per_query["S-mix"] = counts
        emit({"query": "S-mix", "card": smi, "budget": budget,
              "forecasts": {q: {k: s[k] for k in ("peak_hbm",
                                                  "ledger_peak")}
                            for q, s in solo.items()},
              "tickets": tickets, "stats": stats,
              "status_waiting": waiting,
              "status_reserved_bytes": status_reserved,
              "makespan_ms": makespan,
              "serial_ms": SERVE_REPEATS * sum(s["wall_ms"]
                                              for s in solo.values()),
              "walls_ms": walls, "measured_peak_bytes": measured,
              "launches": counts})
        obs.shutdown()

        # --- S-reject: Q11 under a budget below its forecast -------------
        settings, df_of, _ = queries["Q11"]
        low = solo["Q11"]["peak_hbm"] // 2
        sess = S.TpuSession({**settings, **SERVE_ON,
                             "spark.rapids.tpu.memory.hbm.budgetBytes":
                             low}, device=dev)
        sched = QueryScheduler.reset()
        reset_launches()
        try:
            try:
                df_of(sess).collect()
            except ServeAdmissionRejected as e:
                reason = str(e)
            else:
                raise AssertionError("S-reject: Q11 was admitted under "
                                     f"a budget of {low} B")
            recs = sess.events.records()
        finally:
            sess.close()
        counts = launches()
        stats = sched.stats()
        ends = [r for r in recs if r["event"] == "query_end"]
        if (stats["rejected"] != 1 or stats["admitted"] or stats["active"]
                or stats["waiting"] or BufferCatalog.get().reserved_bytes
                or any(counts.values()) or len(ends) != 1
                or not ends[0]["error"]):
            raise AssertionError(f"S-reject: stats {stats}, reserved "
                                 f"{BufferCatalog.get().reserved_bytes} B, "
                                 f"launches {counts}, ends {ends}")
        per_query["S-reject"] = counts
        emit({"query": "S-reject", "card": smi, "budget": low,
              "forecast": solo["Q11"]["peak_hbm"], "error": reason,
              "stats": stats, "launches": counts})
    finally:
        obs.shutdown()
        QueryScheduler.reset()
        SharedPlanCache.reset()
        BufferCatalog.reset()
        DeviceScanCache.reset()
        shutil.rmtree(base, ignore_errors=True)
    return per_query


# ---------------------------------------------------------------------------
# io phase (W-csv, W-csvi, W-orc, W-write, W-ml): TPC-H Q1 from CSV and ORC,
# a CSV -> columnar write round trip and the ML hand-off over Q17's table
# ---------------------------------------------------------------------------
IO_LOG2_ROWS = 23
IO_FILES = 4
#: rows of the ``map_in_arrow`` and ``map_in_pandas`` calls (their results
#: come back as Python lists, as the reference's data plane has them)
IO_ML_ARROW_ROWS = 1 << 20
#: runs of each path: a cold one and warm ones (W-csv: three warm walls)
IO_CSV_RUNS = 4
IO_RUNS = 2
IO_VFA = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
#: the overwrite's narrower filter: a year before Q1's cutoff
IO_NARROW_CUTOFF = "1997-09-02"


def io_schema(T):
    """The ``lineitem`` columns of Q17's file, in its order."""
    return T.StructType(
        [T.StructField(c, T.STRING) for c in ("l_returnflag",
                                              "l_linestatus", "l_shipmode")]
        + [T.StructField(c, T.DOUBLE) for c in ("l_quantity",
                                                "l_extendedprice",
                                                "l_discount", "l_tax")]
        + [T.StructField("l_shipdate", T.INT)])


def device_only(plan, what: str):
    """Fail unless the whole plan runs on the device (no CPU exec, no
    row-to-columnar transition); returns its file scans."""
    from spark_rapids_tpu_torch.exec import (ColumnarToRowExec,
                                             RowToColumnarExec, TpuExec)
    from spark_rapids_tpu_torch.exec.scan import TpuFileSourceScanExec

    if not isinstance(plan, ColumnarToRowExec):
        raise AssertionError(f"{what}: the plan runs on the CPU engine:\n"
                             f"{plan.tree_string()}")
    nodes = list(_device_tree(plan.tpu_child))
    if any(isinstance(n, RowToColumnarExec) or not isinstance(n, TpuExec)
           for n in nodes):
        raise AssertionError(f"{what}: a CPU exec in the plan:\n"
                             f"{plan.tree_string()}")
    return [n for n in nodes if isinstance(n, TpuFileSourceScanExec)]


def need_kernels(what: str, counts, need) -> None:
    """Fail unless every kernel in ``need`` launched and no kernel outside
    the aggregates' (K1-K3, the RADIX kernel) did."""
    aggs = ("bucket_sum", "bucket_float_sum", "bucket_winner",
            "radix_segment_reduce")
    if any(not counts[k] for k in need) or any(
            v for k, v in counts.items() if v and k not in aggs):
        raise AssertionError(f"{what}: launches {dict(counts)}, need "
                             f"{need}")


def write_back_oracle(np, t, cutoff: str):
    """(flag, status) -> [sum qty, |qty|, sum disc_price, |disc_price|,
    count, min mode, max mode] over the rows shipped by ``cutoff``."""
    keep = t["ship"] <= _days(np, cutoff)
    dp = t["price"] * (1 - t["disc"])
    g = (t["flag"] * 2 + t["status"])[keep]
    modes = np.array([m.decode() for m in SHIP_MODES], object)[
        t["mode"][keep]]
    out = {}
    for gid in np.unique(g):
        sel = g == gid
        q, d = t["qty"][keep][sel], dp[keep][sel]
        m = sorted(set(modes[sel]))
        out[(RETURN_FLAGS[gid // 2].decode(),
             LINE_STATUS[gid % 2].decode())] = [
            float(q.sum()), float(np.abs(q).sum()), float(d.sum()),
            float(np.abs(d).sum()), int(sel.sum()), m[0], m[-1]]
    return out, int(keep.sum())


def check_write_back(want: dict, rows, what: str) -> None:
    """Rows of the read-back aggregate against :func:`write_back_oracle`:
    keys, counts and modes exact, sums within 1e-9 of Σ|x|."""
    got = {(r[0], r[1]): r[2:] for r in rows}
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: groups {sorted(got)} != "
                             f"{sorted(want)}")
    for k, (sq, mq, sd, md, cnt, mn, mx) in want.items():
        gq, gd, gc, gmn, gmx = got[k]
        if ((gc, gmn, gmx) != (cnt, mn, mx) or not _close(gq, sq, mq, 1e-9)
                or not _close(gd, sd, md, 1e-9)):
            raise AssertionError(f"{what} {k}: {got[k]} != "
                                 f"{(sq, sd, cnt, mn, mx)}")


def io_phase(torch, np, dev, smi: str) -> dict:
    """W-csv, W-csvi, W-orc, W-write and W-ml (see the module
    docstring) over Q17's ``lineitem`` at 2^23 rows, written under
    ``_chip_data/io``. Returns each path's launches."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow as pa
    import pyarrow.csv as pacsv
    import pyarrow.orc as paorc

    from spark_rapids_tpu_torch import ml
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.sql import session as S

    n = 1 << IO_LOG2_ROWS
    t, want, kept, strs = lineitem_inputs(np, n)
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, PARQUET_DIR, "io")
    shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)
    csv_dir = os.path.join(base, "csv")
    orc_dir = os.path.join(base, "orc")
    schema = io_schema(T)
    cutoff = _days(np, Q17_CUTOFF)
    per_query = {}
    try:
        table = pa.table(
            {**{k: _pa_strings(pa, np, v) for k, v in strs.items()},
             "l_quantity": t["qty"], "l_extendedprice": t["price"],
             "l_discount": t["disc"], "l_tax": t["tax"],
             "l_shipdate": t["ship"]})
        per = n // IO_FILES
        writes = {}
        for fmt, d, write in (
                ("csv", csv_dir, lambda s, p: pacsv.write_csv(s, p)),
                ("orc", orc_dir, lambda s, p: paorc.write_table(s, p))):
            os.makedirs(d)
            t0 = time.perf_counter()
            # one thread a file: pyarrow's encoders release the GIL
            with ThreadPoolExecutor(IO_FILES) as pool:
                list(pool.map(lambda i: write(
                    table.slice(i * per, per),
                    os.path.join(d, f"part-{i}.{fmt}")), range(IO_FILES)))
            writes[fmt] = time.perf_counter() - t0
        csv_bytes = sum(os.path.getsize(os.path.join(csv_dir, f))
                        for f in os.listdir(csv_dir))
        stripes = sum(paorc.ORCFile(os.path.join(orc_dir, f)).nstripes
                      for f in os.listdir(orc_dir))
        emit({"table": "io", "rows": n, "files": IO_FILES,
              "csv_bytes": csv_bytes, "csv_write_s": writes["csv"],
              "orc_write_s": writes["orc"], "orc_stripes": stripes})

        # --- W-csv, W-csvi, W-orc: TPC-H Q1 from the files ---------------
        results = {}
        for q, df_of, runs in (
                ("W-csv", lambda s: s.read.csv(csv_dir, schema=schema),
                 IO_CSV_RUNS),
                ("W-csvi", lambda s: s.read.csv(csv_dir), IO_RUNS),
                ("W-orc", lambda s: s.read.orc(orc_dir), IO_RUNS)):
            S._SCANNER_CACHE.clear()
            sess = S.TpuSession(IO_VFA, device=dev)
            plans, outs = [], []

            def run_once():
                rows = tpch_q1_df(np, sess, None, source=df_of(sess)
                                  ).collect()
                plans.append(sess.last_executed_plan)
                outs.append(rows)
                return rows

            cold, warm, counts = _walls(
                torch, q, run_once, lambda rows: tpch_q1_check(want, rows,
                                                               q), runs)
            scans = device_only(plans[0], q)
            need_kernels(q, counts, ("radix_segment_reduce",))
            per_query[q] = counts
            m = {k: sum(s.metrics[k].value for s in scans)
                 for k in ("scanTime", "tpuDecodeTime", "numOutputRows",
                           "numOutputBatches")}
            line = {"query": q, "card": smi, "rows": n, "kept_rows": kept,
                    "cold_wall_ms": cold, "warm_wall_ms": warm,
                    "host_read_ms": m["scanTime"] / 1e6,
                    "upload_ms": m["tpuDecodeTime"] / 1e6,
                    "host_read_share": m["scanTime"] / 1e6 / cold,
                    "rows_uploaded": m["numOutputRows"],
                    "scan_batches": m["numOutputBatches"],
                    "launches": counts}
            results[q] = outs[0]
            if q == "W-orc":
                pushed = [(f.column, f.op) for s in scans
                          for f in s.scanner.filters]
                if pushed != [("l_shipdate", "<=")] or \
                        m["numOutputRows"] != kept:
                    raise AssertionError(
                        f"W-orc: pushed {pushed}, {m['numOutputRows']} rows "
                        f"uploaded of {n} read (kept {kept})")
                line.update(rows_read=n, stripes=stripes, pushed=pushed)
            else:
                line["csv_bytes"] = csv_bytes
            emit(line)
        if results["W-csvi"] != results["W-csv"]:
            raise AssertionError(f"W-csvi: rows {results['W-csvi']} != "
                                 f"W-csv's {results['W-csv']}")
        emit({"query": "W-csvi", "rows_equal_w_csv_exactly": True})

        # --- W-write: CSV -> parquet, ORC and CSV, and each read back -----
        def projected(sess, cut):
            src = sess.read.csv(csv_dir, schema=schema)
            return src.where(E.LessThanOrEqual(
                E.col("l_shipdate"), E.lit(cut))).select(
                "l_returnflag", "l_linestatus", "l_shipmode", "l_quantity",
                E.Alias(E.Multiply(E.col("l_extendedprice"), E.Subtract(
                    E.lit(1.0), E.col("l_discount"))), "disc_price"))

        def read_back(sess, fmt, path):
            src = (sess.read.csv(path, schema=T.StructType(
                [T.StructField(c, T.STRING) for c in
                 ("l_returnflag", "l_linestatus", "l_shipmode")]
                + [T.StructField(c, T.DOUBLE) for c in
                   ("l_quantity", "disc_price")]))
                   if fmt == "csv" else getattr(sess.read, fmt)(path))
            return src.group_by("l_returnflag", "l_linestatus").agg(
                A.agg(A.Sum(E.col("l_quantity")), "sum_qty"),
                A.agg(A.Sum(E.col("disc_price")), "sum_disc_price"),
                A.agg(A.Count(None), "count"),
                A.agg(A.Min(E.col("l_shipmode")), "min_mode"),
                A.agg(A.Max(E.col("l_shipmode")), "max_mode"))

        wb, wb_kept = write_back_oracle(np, t, Q17_CUTOFF)
        out_dir = os.path.join(base, "out")
        DeviceScanCache.reset()
        sess = S.TpuSession(IO_VFA, device=dev)
        for fmt, need in (("parquet", ("bucket_sum", "bucket_float_sum",
                                       "bucket_winner")),
                          ("orc", ("radix_segment_reduce",)),
                          ("csv", ("radix_segment_reduce",))):
            q = f"W-write-{fmt}"
            path = os.path.join(out_dir, f"lineitem.{fmt}")
            S._SCANNER_CACHE.clear()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            stats = getattr(projected(sess, cutoff).write, fmt)(path)
            write_ms = (time.perf_counter() - t0) * 1e3
            device_only(sess.last_executed_plan, q)
            wrote = stats["numRows" if fmt == "parquet" else "rows"]
            left = [f for f in os.listdir(out_dir) if "._temporary" in f]
            if wrote != wb_kept or left:
                raise AssertionError(f"{q}: {stats}, expected {wb_kept} "
                                     f"rows; left behind: {left}")
            plans = []

            def run_once():
                rows = read_back(sess, fmt, path).collect()
                plans.append(sess.last_executed_plan)
                return rows

            cold, warm, counts = _walls(
                torch, q, run_once, lambda rows: check_write_back(wb, rows,
                                                                  q),
                IO_RUNS)
            device_only(plans[0], q)
            need_kernels(q, counts, need)
            per_query[q] = counts
            emit({"query": q, "card": smi, "rows": wb_kept, "stats": stats,
                  "file_bytes": os.path.getsize(path), "write_ms": write_ms,
                  "cold_wall_ms": cold, "warm_wall_ms": warm,
                  "launches": counts})
        # overwrite the parquet file, now cached on the device and in the
        # session's scanners, with a narrower filter: the commit drops the
        # file's cache entries and scanners, and the next read, through
        # the same session with nothing cleared by hand, gives the new rows
        path = os.path.join(out_dir, "lineitem.parquet")
        cache = DeviceScanCache._instance
        before = cache.stats()
        narrow, narrow_kept = write_back_oracle(np, t, IO_NARROW_CUTOFF)
        t0 = time.perf_counter()
        stats = projected(sess, _days(np, IO_NARROW_CUTOFF)).write.parquet(
            path)
        write_ms = (time.perf_counter() - t0) * 1e3
        after = cache.stats()
        check_write_back(narrow, read_back(sess, "parquet", path).collect(),
                         "W-write-overwrite")
        if (stats["numRows"] != narrow_kept or not before["entries"]
                or after["entries"] or after["bytes"]):
            raise AssertionError(f"W-write-overwrite: {stats}, cache before "
                                 f"{before}, after {after}")
        emit({"query": "W-write-overwrite", "card": smi,
              "rows": narrow_kept, "write_ms": write_ms,
              "cache_before": before, "cache_after_commit": after})

        # --- W-ml: the device batches to an ML consumer -------------------
        ml_on = {**IO_VFA, "spark.rapids.tpu.sql.exportColumnarRdd": True}
        sess = S.TpuSession(ml_on, device=dev)
        S._SCANNER_CACHE.clear()
        nums = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")

        def numeric(s):
            return s.read.csv(csv_dir, schema=schema).where(
                E.LessThanOrEqual(E.col("l_shipdate"), E.lit(cutoff))
            ).select(*nums)

        keep = t["ship"] <= cutoff
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        total = batches = 0
        for b in ml.columnar_rdd(numeric(sess)):
            if not all(c.data.is_cuda and c.validity.is_cuda
                       for c in b.columns):
                raise AssertionError("W-ml: a batch column off the card")
            total += b.num_rows
            batches += 1
        rdd_ms = (time.perf_counter() - t0) * 1e3
        shared = 0
        for cols in ml.to_dlpack_batches(numeric(sess)):
            for c in cols:
                if torch.from_dlpack(c).data_ptr() != c.data_ptr() or \
                        not c.is_cuda:
                    raise AssertionError("W-ml: DLPack copied a column")
                shared += 1
        t0 = time.perf_counter()
        mats = list(ml.to_numpy_batches(numeric(sess)))
        numpy_ms = (time.perf_counter() - t0) * 1e3
        got = [np.concatenate([m[j] for m in mats]) for j in range(4)]
        exp = [t["qty"][keep], t["price"][keep], t["disc"][keep],
               t["ship"][keep].astype(np.float64)]
        if total != kept or not all(np.array_equal(g, e)
                                    for g, e in zip(got, exp)):
            raise AssertionError(f"W-ml: {total} rows exported, expected "
                                 f"{kept}, or a numpy column differs")
        rdd_counts = launches()
        ml_csv = os.path.join(base, "ml.csv")
        pacsv.write_csv(table.slice(0, IO_ML_ARROW_ROWS), ml_csv)

        def year_and_price(tb):
            import pyarrow.compute as pc

            return pa.table({
                "year": pc.divide(pc.cast(tb.column("l_shipdate"),
                                          pa.int64()), 365),
                "disc_price": pc.multiply(
                    tb.column("l_extendedprice"),
                    pc.subtract(1.0, tb.column("l_discount")))})

        def year_and_price_pandas(pdf):
            import pandas as pd

            return pd.DataFrame({
                "year": pdf["l_shipdate"].astype("int64") // 365,
                "disc_price": pdf["l_extendedprice"]
                * (1.0 - pdf["l_discount"])})

        out_schema = T.StructType([T.StructField("year", T.LONG),
                                   T.StructField("disc_price", T.DOUBLE)])
        sub = slice(0, IO_ML_ARROW_ROWS)
        yr = t["ship"][sub].astype(np.int64) // 365
        dp = t["price"][sub] * (1 - t["disc"][sub])
        mapped = {}
        for how, fn, call in (
                ("arrow", year_and_price, ml.map_in_arrow),
                ("pandas", year_and_price_pandas, ml.map_in_pandas)):
            q = "W-ml" if how == "arrow" else "W-ml-pandas"
            S._SCANNER_CACHE.clear()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            rows = call(sess.read.csv(ml_csv, schema=schema), fn,
                        out_schema).group_by("year").agg(
                A.agg(A.Sum(E.col("disc_price")), "s"),
                A.agg(A.Count(None), "c")).collect()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = launches()
            device_only(sess.last_executed_plan, q)
            need_kernels(q, counts, ("bucket_sum", "bucket_float_sum"))
            got = {r[0]: r[1:] for r in rows}
            if sorted(got) != sorted(np.unique(yr).tolist()):
                raise AssertionError(f"{q}: years {sorted(got)}")
            for y, (sm, c) in got.items():
                sel = yr == y
                if c != int(sel.sum()) or not _close(
                        sm, float(dp[sel].sum()),
                        float(np.abs(dp[sel]).sum()), 1e-9):
                    raise AssertionError(f"{q} {y}: {(sm, c)}")
            per_query[q] = counts
            mapped[how] = {"ms": ms, "launches": counts}
        emit({"query": "W-ml", "card": smi, "rows": n, "kept_rows": kept,
              "exported_rows": total, "batches": batches,
              "dlpack_columns_shared": shared, "columnar_rdd_ms": rdd_ms,
              "to_numpy_ms": numpy_ms, "export_launches": rdd_counts,
              "map_rows": IO_ML_ARROW_ROWS, "groups": len(got),
              "map_in_arrow_group_by_ms": mapped["arrow"]["ms"],
              "map_in_pandas_group_by_ms": mapped["pandas"]["ms"],
              "pandas_launches": mapped["pandas"]["launches"],
              "launches": mapped["arrow"]["launches"]})
    finally:
        DeviceScanCache.reset()
        S._SCANNER_CACHE.clear()
        shutil.rmtree(os.path.join(here, PARQUET_DIR), ignore_errors=True)
    return per_query


# ---------------------------------------------------------------------------
# cost phase: the cost plane, donation and the kernel-library cache (item
# 26.2) over Q1, Q2, Q6 and Q10
# ---------------------------------------------------------------------------
#: the hand kernels each rerun query launches (its own phase's counts)
COST_KERNELS = {"Q1": ("bucket_sum", "bucket_float_sum"),
                "Q2": ("bucket_sum", "bucket_winner"),
                "Q6": ("probe_ranges", "bucket_sum"),
                "Q10": ("word_counts", "bucket_sum")}
#: the sites an aggregate harvests by the route it took (AGG_ROUTES)
ROUTE_SITES = {"stage": ("agg_stage",), "plan": ("agg_plan",),
               "update": ("agg_update", "agg_merge")}
#: rows of Q1 in the kernel-library cache's fresh processes (Q1's own)
CACHE_Q1_LOG2_ROWS = 26
#: Q1's and Q6's fact rows in the cost phase (their phases' defaults)
COST_Q1_LOG2_ROWS = 26
COST_JOIN_LOG2_ROWS = 23


def q1_inputs(np, torch, dev, log2_rows: int, nbatches: int = 4):
    """Q1's table (``query_phase``'s, seeded alike) in ``nbatches``
    device batches: (batches, schema, check(rows, what))."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import schema_of

    n = 1 << log2_rows
    rng = np.random.default_rng(42)
    k = rng.integers(0, 64, n).astype(np.int32)
    a = rng.integers(-(10**6), 10**6, n).astype(np.int64)
    b = rng.normal(size=n)
    b_null = rng.random(n) < 0.05
    schema = schema_of(k=T.INT, a=T.LONG, b=T.DOUBLE)
    ones = np.ones(n, bool)
    batches = _batches(np, torch, schema, [k, a, np.where(b_null, 0.0, b)],
                       [ones, ones, ~b_null], nbatches, dev)
    m = a >= 0
    mb = m & ~b_null
    s_exp = np.bincount(k[m], weights=(2 * a[m]).astype(np.float64),
                        minlength=64)
    c_exp = np.bincount(k[mb], minlength=64)
    bsum = np.bincount(k[mb], weights=b[mb], minlength=64)
    babs = np.bincount(k[mb], weights=np.abs(b[mb]), minlength=64)
    groups = set(np.unique(k[m]).tolist())

    def check(rows, what):
        got = {r[0]: r[1:] for r in rows}
        if set(got) != groups:
            raise AssertionError(f"{what}: group set differs from the "
                                 "oracle")
        for g, (s, mean, c) in got.items():
            if s != int(s_exp[g]) or c != int(c_exp[g]) or not _close(
                    mean, bsum[g] / c_exp[g], babs[g] / c_exp[g]):
                raise AssertionError(f"{what} group {g}: {(s, mean, c)}")

    return batches, schema, check


def q1_over(conf, scan):
    """Q1 over ``scan``: filter a >= 0, project a2 = a*2, group by k:
    sum(a2), avg(b), count(b)."""
    from spark_rapids_tpu_torch.exec import (TpuFilterExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col, lit

    filt = TpuFilterExec(conf, E.GreaterThanOrEqual(col("a"), lit(0)), scan)
    proj = TpuProjectExec(conf, [col("k"), E.Alias(
        E.Multiply(col("a"), lit(2)), "a2"), col("b")], filt)
    return TpuHashAggregateExec(conf, [col("k")], [
        A.agg(A.Sum(col("a2")), "s"), A.agg(A.Average(col("b")), "m"),
        A.agg(A.Count(col("b")), "c")], proj)


def cache_child(cache_dir: str, log2_rows: int) -> None:
    """One fresh process of the cost phase's cache check: Q1 as its first
    query with the kernel-library cache in ``cache_dir``, then every other
    library loaded; prints one JSON line (walls, compile misses, the
    cache's stats, launches)."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import InMemoryScanExec
    from spark_rapids_tpu_torch.ops import _cuda_build
    from spark_rapids_tpu_torch.serve import program_cache

    conf = RapidsConf(CACHE_CONF | {"spark.rapids.tpu.aotCache.dir":
                                    cache_dir})
    program_cache.install(conf)
    dev = torch.device("cuda")
    batches, schema, check = q1_inputs(np, torch, dev, log2_rows)
    reset_launches()
    rows, wall = _run(torch, q1_over(conf, InMemoryScanExec(
        conf, [batches], schema)), conf)
    counts = launches()
    check(rows, "Q1 (cache child)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_kernel_modules())) as pool:
        list(pool.map(lambda mod: mod.build_kernels(), _kernel_modules()))
    rows2, warm = _run(torch, q1_over(conf, InMemoryScanExec(
        conf, [batches], schema)), conf)
    check(rows2, "Q1 (cache child, warm)")
    print(json.dumps({"cache_child": {
        "first_query_wall_ms": wall, "warm_wall_ms": warm,
        "other_libraries_s": time.perf_counter() - t0,
        "compile_misses": _cuda_build.compile_miss_count(),
        "nvcc": _cuda_build.compiler_version(),
        "stats": program_cache.stats(),
        "launches": {k: v for k, v in counts.items() if v}}}), flush=True)


#: the conf of the cache check's processes (its fingerprint keys the
#: entries, so the parent's truncation check uses the same)
CACHE_CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


def _cache_phase(torch, here: str, smi: str) -> dict:
    """The kernel-library cache: a fresh process stores the 5 libraries
    (running Q1 first), a second one with no ``nvcc`` (none on ``PATH``,
    ``CUDA_HOME`` empty) runs Q1 on hits only, and a truncated entry is
    poisoned and rebuilt."""
    import shutil
    import tempfile

    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.ops import udf_kernels as UK
    from spark_rapids_tpu_torch.serve import program_cache

    cache_dir = tempfile.mkdtemp(prefix="srt_aot_")
    no_cuda = tempfile.mkdtemp(prefix="srt_nocuda_")
    out = {}
    try:
        code = ("import sys, chip_smoke; chip_smoke.cache_child("
                f"{cache_dir!r}, {CACHE_Q1_LOG2_ROWS})")
        base_env = dict(os.environ, PYTHONPATH=here)
        bare_path = os.pathsep.join(
            d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc")))
        for what, env in (("store", base_env),
                          ("hit", dict(base_env, PATH=bare_path,
                                       CUDA_HOME=no_cuda))):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-c", code], cwd=here,
                                 env=env, capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"cache child ({what}) failed:\n"
                                     f"{res.stdout[-2000:]}"
                                     f"{res.stderr[-4000:]}")
            line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith('{"cache_child"')][-1]
            out[what] = json.loads(line)["cache_child"]
            out[what]["process_s"] = time.perf_counter() - t0
        st, hit = out["store"], out["hit"]
        if st["stats"]["puts"] != 5 or st["compile_misses"] != 5:
            raise AssertionError(f"cache store: {st}")
        if (hit["compile_misses"] or hit["nvcc"] is not None
                or hit["stats"]["hits"] != 5 or hit["stats"]["misses"]
                or hit["stats"]["corrupt"]):
            raise AssertionError(f"cache hit (no nvcc): {hit}")
        if hit["launches"] != st["launches"]:
            raise AssertionError(f"cache hit launches {hit['launches']} != "
                                 f"{st['launches']}")
        # a truncated entry: poisoned, then rebuilt from the source
        pc = program_cache.ProgramCache(RapidsConf(
            CACHE_CONF | {"spark.rapids.tpu.aotCache.dir": cache_dir}))
        entry = os.path.join(cache_dir, pc.entry_name(pc.identity(
            UK.SOURCE)))
        size = os.path.getsize(entry)
        with open(entry, "r+b") as f:
            f.truncate(size // 2)
        lib, saved = pc.load_library(UK.SOURCE, [], UK.SYMBOLS)
        s = pc.stats.to_json()
        rebuilt = pc._read_entry(entry)[0]  # whole again
        if (saved is not None or s["corrupt"] != 1 or s["puts"] != 1
                or not rebuilt["blob_len"]):
            raise AssertionError(f"truncated entry: {s}, saved {saved}")
        out["truncated"] = {"entry_bytes": size, "stats": s}
        emit({"cost": "kernel_library_cache", "card": smi,
              "store_first_query_wall_ms": st["first_query_wall_ms"],
              "hit_first_query_wall_ms": hit["first_query_wall_ms"],
              "store_warm_wall_ms": st["warm_wall_ms"],
              "hit_warm_wall_ms": hit["warm_wall_ms"],
              "store_other_libraries_s": st["other_libraries_s"],
              "hit_other_libraries_s": hit["other_libraries_s"],
              "store_process_s": st["process_s"],
              "hit_process_s": hit["process_s"],
              "store_stats": st["stats"], "hit_stats": hit["stats"],
              "hit_nvcc": hit["nvcc"], "truncated": out["truncated"]})
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        shutil.rmtree(no_cuda, ignore_errors=True)
    return out


def _donation_runs(torch, np, dev, smi: str, q1, bench) -> dict:
    """Q1 and Q6 over host-resident scans, donation on (the witness on)
    and off: rows equal, donated bytes at the aggregate's update and at
    the join, each run's wall and peak device memory; then a read of a
    donated plane raises ``TpuDonationViolation``."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec,
                                             TpuShuffledHashJoinExec)
    from spark_rapids_tpu_torch.exec.base import vals_of_batch
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.plugin import donation

    host = {"spark.rapids.tpu.sql.inMemoryScan.hostResident": True}
    off = {"spark.rapids.tpu.sql.donation.enabled": False}
    batches, schema, check = q1
    fact, dim, want6, fs, ds = bench
    q1_scan = InMemoryScanExec(RapidsConf(host), [batches], schema)
    f_scan = InMemoryScanExec(RapidsConf(host), [fact], fs)
    d_scan = InMemoryScanExec(RapidsConf(host), [dim], ds)

    def q1_of(c):
        return q1_over(RapidsConf(CACHE_CONF | c), q1_scan)

    def q6_of(c):
        conf = RapidsConf({"spark.rapids.tpu.sql.join.strategy": "PALLAS",
                           **c})
        join = TpuShuffledHashJoinExec(conf, f_scan, d_scan, [col("fk")],
                                       [col("dk")], "inner")
        return TpuHashAggregateExec(conf, [col("fv")], [
            A.agg(A.Sum(col("dv")), "s"), A.agg(A.Count(None), "c")], join)

    def checked6(rows, what):
        if sorted(rows) != want6:
            raise AssertionError(f"{what}: rows differ from the oracle")

    res = {}
    for q, plan_of, chk in (("Q1", q1_of, check), ("Q6", q6_of, checked6)):
        _run(torch, plan_of(off), RapidsConf(off))  # the host pull, once
        got = {}
        for mode in ("off", "on", "on", "off"):
            c = off if mode == "off" else {}
            if mode == "on":
                donation.install_witness()
            snap = donation.snapshot_counters()
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            try:
                rows, wall = _run(torch, plan_of(c), RapidsConf(c))
            finally:
                donation.uninstall_witness()
            chk(rows, f"{q}-donate-{mode}")
            donated = donation.counters_since(snap)
            run = {"wall_ms": wall,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "base_bytes": base, "donated": donated,
                   "launches": {k: v for k, v in launches().items() if v}}
            got.setdefault(mode, []).append((sorted(rows), run))
        a, b = got["on"][0][0], got["off"][0][0]
        if len(a) != len(b) or any(
                x[:1] != y[:1] or any(
                    (u != v) if isinstance(u, int) or u is None else
                    not _close(u, v, abs(v)) for u, v in zip(x[1:], y[1:]))
                for x, y in zip(a, b)):
            raise AssertionError(f"{q}: donation-on rows != donation-off")
        for _, run in got["on"]:
            # the aggregate's update (streaming or the fused plan) and,
            # in Q6, the join's probe
            d = run["donated"]
            if (d.get("agg_update", 0) + d.get("agg_plan", 0) <= 0
                    or q == "Q6" and d.get("join", 0) <= 0):
                raise AssertionError(f"{q}: donated {d}")
        for _, run in got["off"]:
            if run["donated"]:
                raise AssertionError(f"{q}: donated with donation off: "
                                     f"{run['donated']}")
        if got["on"][0][1]["launches"] != got["off"][0][1]["launches"]:
            raise AssertionError(f"{q}: launches differ on/off")
        res[q] = {m: [r for _, r in runs] for m, runs in got.items()}
        emit({"cost": "donation", "query": q, "card": smi,
              "on": res[q]["on"], "off": res[q]["off"]})
    # a read of a donated plane, under the witness
    conf = RapidsConf(host)
    b = next(InMemoryScanExec(conf, [batches[:1]], schema)
             .execute_partition(0))
    donation.install_witness()
    try:
        with donation.guard("agg_update", b, op="chip_smoke", conf=conf):
            pass
        try:
            vals_of_batch(b)
        except donation.TpuDonationViolation as e:
            res["violation"] = str(e)
        else:
            raise AssertionError("a donated plane was read without "
                                 "TpuDonationViolation")
    finally:
        donation.uninstall_witness()
    emit({"cost": "donation_violation", "raised": res["violation"]})
    return res


def cost_phase(torch, np, dev, smi: str, per_query: dict, kres: dict,
               wc_batches) -> dict:
    """Q1, Q2, Q6 and Q10 at their phases' full widths with the event log,
    the live plane and the device lane on: each query's launches equal its
    own phase's; each (site, digest) harvested once (one ``program_cost``
    and its ``hlo_summary`` twin); each hand kernel on a path in its
    site's top rows with a profiler ``device_ms`` above 0 (printed beside
    the kernel phase's ``ms``); a rerun harvests nothing;
    ``tools/tpu_profile.py`` over the log prints its ``== roofline ==``
    and ``== hlo ==`` sections naming the sites. Then donation
    (:func:`_donation_runs`) and the kernel-library cache
    (:func:`_cache_phase`)."""
    import shutil
    import tempfile

    from spark_rapids_tpu_torch import events, kernel_cost, obs
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec,
                                             TpuProjectExec)
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import expressions as E
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.udf import string_word_count

    here = os.path.dirname(os.path.abspath(__file__))
    logs = tempfile.mkdtemp(prefix="srt_cost_")
    on = {"spark.rapids.tpu.eventLog.dir": logs,
          "spark.rapids.tpu.metrics.live.enabled": True,
          "spark.rapids.tpu.metrics.deviceSync.enabled": True}
    conf1 = RapidsConf(CACHE_CONF | on)
    conf2 = RapidsConf(on)
    q1 = q1_inputs(np, torch, dev, COST_Q1_LOG2_ROWS)
    batches, schema, check1 = q1
    fact, dim, want6, bench_plan = bench_join(
        torch, np, dev, 1 << COST_JOIN_LOG2_ROWS, DIM_ROWS)
    wb, schema10, k10, words, valid10 = wc_batches
    sw = np.bincount(k10, weights=np.where(valid10, words, 0), minlength=64)
    cw = np.bincount(k10[valid10], minlength=64)
    c10 = np.bincount(k10, minlength=64)
    want10 = [(g, int(sw[g]), int(cw[g]), int(c10[g])) for g in range(64)
              if c10[g]]

    def q2_plan(conf):
        return TpuHashAggregateExec(conf, [col("k")], [
            A.agg(A.Min(col("b")), "mn"), A.agg(A.Max(col("a")), "mx"),
            A.agg(A.First(col("a")), "f"), A.agg(A.Last(col("b")), "l")],
            InMemoryScanExec(conf, [batches], schema))

    def q10_plan(conf):
        proj = TpuProjectExec(conf, [col("k"), E.Alias(
            string_word_count(col("s")), "wc")],
            InMemoryScanExec(conf, [wb], schema10))
        return TpuHashAggregateExec(conf, [col("k")], [
            A.agg(A.Sum(col("wc")), "sw"), A.agg(A.Count(col("wc")), "cw"),
            A.agg(A.Count(None), "c")], proj)

    conf6 = RapidsConf({"spark.rapids.tpu.sql.join.strategy": "PALLAS",
                        **on})
    queries = (
        ("Q1", lambda: q1_over(conf1, InMemoryScanExec(conf1, [batches],
                                                       schema)), conf1,
         lambda rows: check1(rows, "Q1-cost")),
        ("Q2", lambda: q2_plan(conf2), conf2, same_rows("Q2-cost")),
        ("Q6", lambda: bench_plan(conf6)[1], conf6,
         lambda rows: sorted(rows) == want6 or _fail("Q6-cost: rows")),
        ("Q10", lambda: q10_plan(conf2), conf2,
         lambda rows: sorted(rows) == want10 or _fail("Q10-cost: rows")))
    logger = events.EventLogger(conf1)
    events.install(logger)
    obs.ensure_started(conf1)
    kernel_cost.reset_seen()
    out = {"queries": {}}
    all_sites = set()
    try:
        t_phase = time.perf_counter()
        for q, plan, conf, chk in queries:
            seq = kernel_cost.snapshot()
            reset_launches()
            rows, wall = _run(torch, plan(), conf)
            counts = launches()
            chk(rows)
            want = {k: v for k, v in per_query[q].items() if v}
            if {k: v for k, v in counts.items() if v} != want:
                raise AssertionError(f"{q}-cost: launches {counts} != its "
                                     f"phase's {want}")
            recs = [r for r in kernel_cost.records_since(seq)
                    if "device_ms" in r]
            sums = kernel_cost.summaries_since(seq)
            keys = [(r["site"], r["digest"]) for r in recs]
            if len(keys) != len(set(keys)) or sorted(keys) != sorted(
                    (s["site"], s["digest"]) for s in sums):
                raise AssertionError(f"{q}-cost: program_cost {keys} vs "
                                     "hlo_summary twins")
            sites = {s for s, _ in keys}
            need = {s for r in counts.agg_route for s in ROUTE_SITES[r]}
            need |= {"join"} if q == "Q6" else set()
            if not need <= sites:
                raise AssertionError(f"{q}-cost: sites {sites}, need "
                                     f"{need} (routes {counts.agg_route})")
            all_sites |= sites
            found = {}
            for s in sums:
                for row in s["top_fusions"]:
                    if row["op"].startswith("srt::"):
                        name = row["op"][len("srt::"):]
                        if row["device_ms"] > found.get(name, (0, ""))[0]:
                            found[name] = (row["device_ms"], s["site"])
            for name in COST_KERNELS[q]:
                if dev.type == "cuda" and found.get(name, (0,))[0] <= 0:
                    raise AssertionError(
                        f"{q}-cost: {name} not in a site's top rows with "
                        f"device time ({found}); summaries: " + json.dumps(
                            [(s["site"], s["instructions"], s["coverage"],
                              [(x["op"], x["bytes"], x["device_ms"])
                               for x in s["top_fusions"]])
                             for s in sums])[:4000])
                if name in found:
                    emit({"cost": "kernel_device_ms", "query": q,
                          "kernel": name, "site": found[name][1],
                          "profiler_device_ms": found[name][0],
                          "kernel_phase_ms": kres.get((name, 128), {})
                          .get("ms"), "card": smi})
            # a rerun in the same process harvests nothing
            seq2 = kernel_cost.snapshot()
            reset_launches()
            rows2, warm = _run(torch, plan(), conf)
            chk(rows2)
            if kernel_cost.records_since(seq2):
                raise AssertionError(f"{q}-cost: the rerun harvested "
                                     f"{kernel_cost.records_since(seq2)}")
            out["queries"][q] = {
                "harvested_wall_ms": wall, "warm_wall_ms": warm,
                "programs": [{k: r.get(k) for k in (
                    "site", "digest", "trace_ms", "compile_ms", "device_ms",
                    "bytes_accessed", "argument_bytes", "output_bytes",
                    "temp_bytes", "alias_bytes", "flops")} for r in recs],
                "summaries": [{"site": s["site"], "coverage": s["coverage"],
                               "accounted_frac": s["accounted_frac"],
                               "scatter_count": s["scatter_count"],
                               "top": [(x["name"], x["class"], x["bytes"],
                                        x["device_ms"])
                                       for x in s["top_fusions"]]}
                              for s in sums]}
            emit({"cost": "query", "query": q, "card": smi,
                  **out["queries"][q], "launches": counts})
        out["harvest_s"] = time.perf_counter() - t_phase
    finally:
        events.uninstall()
        logger.close()
        obs.shutdown()
    # the profile tool over the phase's log: its sections, not its exit
    # code (its forecast-vs-actual lines read a library build as a
    # program compile miss)
    res = subprocess.run([sys.executable, os.path.join(here, "tools",
                                                       "tpu_profile.py"),
                          logs], capture_output=True, text=True,
                         timeout=300)
    text = res.stdout
    shutil.rmtree(logs, ignore_errors=True)
    roof = text.split("== roofline ==", 1)[1].split("\n==", 1)[0] \
        if "== roofline ==" in text else ""
    hlo = text.split("== hlo ==", 1)[1].split("\n==", 1)[0] \
        if "== hlo ==" in text else ""
    for name, sec in (("roofline", roof), ("hlo", hlo)):
        missing = [s for s in all_sites if f"site={s} " not in sec]
        if not sec or missing:
            raise AssertionError(f"tpu_profile == {name} ==: sites "
                                 f"{missing} missing:\n{text[-3000:]}")
    named = sorted(k for q in COST_KERNELS.values() for k in q
                   if k in hlo)
    emit({"cost": "tpu_profile", "rc": res.returncode,
          "roofline": roof.strip().splitlines(),
          "hlo": hlo.strip().splitlines(), "hand_kernels_named": named})
    out["donation"] = _donation_runs(
        torch, np, dev, smi, q1, (fact, dim, want6,
                                  fact[0].schema, dim[0].schema))
    del q1, batches, fact, dim
    torch.cuda.empty_cache()
    out["cache"] = _cache_phase(torch, here, smi)
    return {}


def _fail(what: str):
    raise AssertionError(what)


def same_rows(what: str):
    """A check that keeps the first rows it is given and holds every
    later call to them exactly (a query with no float sum)."""
    first = []

    def check(rows):
        if not first:
            first.append(sorted(rows))
        elif sorted(rows) != first[0]:
            raise AssertionError(f"{what}: a rerun's rows differ")
    return check


def _decode_threads() -> int:
    from spark_rapids_tpu_torch.io import parquet_device as PD

    return PD.DECODE_THREADS


def build_all() -> dict:
    """Build every kernel library from the sources beside this script,
    one ``nvcc`` per source, and the native host library (one ``g++``),
    all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_tpu_torch import native

    t0 = time.perf_counter()
    mods = _kernel_modules()
    with ThreadPoolExecutor(len(mods) + 1) as pool:
        host = pool.submit(native.available)  # the C++ host decoders (g++)
        list(pool.map(lambda mod: mod.build_kernels(), mods))
        if not host.result():
            raise RuntimeError(f"native library: {native.BUILD_ERROR}")
    return {"build_s": time.perf_counter() - t0,
            "ptxas": {mod.SOURCE.name: [
                ln.strip() for ln in "".join(mod.BUILD_LOG).splitlines()
                if "entry function" in ln or "registers" in ln
                or "spill" in ln] for mod in mods}}


def kernels_line(kres: dict, per_query: dict) -> list:
    """One entry per kernel: its own path's launches, every path's, and
    the kernel phase's numbers at the main path's shape (the groupby
    kernels at the direct tier of Q1's table; K4 at the bench join's
    shape; K5 on a Q10 batch); then K1 and K3 at Q4's shape, K4 at Q8's
    and on Q18's string chunk words, the ordered sum on one partial of
    Q17 and of Q18, K1 and K3 on Q19(c)'s direct tier (K3 on its
    string ranks), and the RADIX kernel at Q4's shape (its main entry:
    one Q17v partial's call), each with its own path. Every bound is
    bytes; the ordered sum also gives its chain bound
    (``bound_chain_ms``)."""
    kernels = []
    # (entry name, kernel, shape key in the kernel phase, path)
    shapes = [(name, name, 128, path) for name, path in PATH.items()]
    shapes += [("bucket_sum@Q4", "bucket_sum", "Q4", "Q4"),
               ("bucket_winner@Q4", "bucket_winner", "Q4", "Q4"),
               ("probe_ranges@Q8", "probe_ranges", "Q8", "Q8"),
               ("ordered_segment_sum@Q17", "ordered_segment_sum", "Q17",
                "Q17"),
               ("ordered_segment_sum@Q18", "ordered_segment_sum", "Q18",
                "Q18"),
               ("probe_ranges@Q18", "probe_ranges", "Q18", "Q18"),
               ("bucket_sum@Q19c", "bucket_sum", "Q19c", "Q19c"),
               ("bucket_winner@Q19c", "bucket_winner", "Q19c", "Q19c"),
               ("bucket_sum@Q20v", "bucket_sum", "Q20v", "Q20v"),
               ("bucket_float_sum@Q20v", "bucket_float_sum", "Q20v",
                "Q20v"),
               ("bucket_winner@Q21a", "bucket_winner", "Q21a", "Q21a"),
               ("radix_segment_reduce@Q4", "radix_segment_reduce", "Q4",
                "Q4")]
    for entry, name, key, path in shapes:
        r = kres[(name, key)]
        line = {"name": entry, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "path": path,
                "launches": per_query[path][name],
                "launches_by_path": {q: c[name] for q, c
                                     in per_query.items()},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": "bytes", "library_ms": r["library_ms"]}
        for extra in ("dev_ms", "host_ms", "plain_rows", "bound_abi_ms",
                      "log2_buckets", "library", "passes", "replicas",
                      "bound_chain_ms", "longest_segment", "segments",
                      "dadd_ns", "bound_whole_ms", "walked_bytes",
                      "walked_sectors", "bound_sectors_ms", "ptxas",
                      "rows", "streams", "ref_tile",
                      "forced_tile_checked"):
            if extra in r:
                line[extra] = r[extra]
        kernels.append(line)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-rows", type=int, default=26,
                    help="rows of the bench table, as a power of two")
    ap.add_argument("--kernel-log2-rows", type=int, default=24)
    ap.add_argument("--join-log2-rows", type=int, default=23,
                    help="fact rows of the bench join (Q6, Q7, K4's probe "
                    "side), as a power of two; Q8 takes 1/8 of them")
    ap.add_argument("--string-log2-rows", type=int, default=22,
                    help="rows of Q9 and of Q10 (in 4 batches; K5 runs on "
                    "the first batch), as a power of two")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also profile Q1, Q2, Q5, Q6, Q7, Q10, Q11 "
                    "(warm), Q13-Q17, Q18 (PALLAS and AUTO), Q19 (a, b, "
                    "c), Q20, Q20v, Q21 (a, b), Q22, Q22d, Q23, Q24 and "
                    "Q24c with torch.profiler (Q9 and Q9x are profiled in "
                    "every run)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        _kernel_modules()
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script "
              f"({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]

    phase_s = {}
    last = [time.perf_counter()]

    def lap(name):
        """Seconds since the previous lap, under ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

    emit(build_all())
    lap("build")
    kres = kernel_phase(torch, np, dev, 1 << args.kernel_log2_rows, args.reps)
    kres[("probe_ranges", 128)], kres[("probe_ranges", "Q8")] = (
        join_kernel_phase(torch, np, dev, 1 << args.join_log2_rows,
                          DIM_ROWS, args.reps))
    wc_batches = _word_count_batches(np, dev, args.string_log2_rows)
    first = wc_batches[0][0]
    kres[("word_counts", 128)] = udf_kernel_phase(
        torch, np, dev, first, wc_batches[3][:first.num_rows], args.reps)
    lap("kernels")
    per_query, shapes = query_phase(torch, np, dev, args.log2_rows, 4,
                                    args.profile, args.reps)
    kres.update(shapes)
    lap("Q1-Q5")
    per_query.update(join_query_phase(torch, np, dev, args.join_log2_rows,
                                      DIM_ROWS, args.profile))
    lap("Q6-Q8")
    per_query.update(string_query_phase(torch, np, dev,
                                        args.string_log2_rows, wc_batches,
                                        args.profile))
    lap("Q9-Q10")
    per_query.update(sort_window_phase(torch, np, dev, SORT_LOG2_ROWS,
                                       args.profile))
    lap("Q13-Q14")
    per_query.update(session_query_phase(torch, np, dev,
                                         PARQUET_LOG2_ROWS,
                                         UDF_LOG2_ROWS, args.profile))
    lap("Q11-Q16")
    strings, shapes = string_key_phase(
        torch, np, dev, STRING_LOG2_ROWS, DIM_ROWS, args.reps,
        kres[("ordered_segment_sum", 128)]["dadd_ns"], args.profile)
    per_query.update(strings)
    kres.update(shapes)
    lap("Q17-Q19")
    strings, shapes = dict_string_phase(torch, np, dev, STRING_LOG2_ROWS,
                                        args.reps, args.profile)
    per_query.update(strings)
    kres.update(shapes)
    lap("Q20-Q21")
    strings, shapes = string_expr_phase(torch, np, dev, ORDERS_LOG2_ROWS,
                                        args.reps, args.profile)
    per_query.update(strings)
    kres.update(shapes)
    lap("Q22-Q24")
    per_query.update(exchange_phase(torch, np, dev))
    lap("Q11m-Q14m")
    per_query.update(decimal_date_phase(torch, np, dev))
    lap("Q25-Q27")
    per_query.update(nested_loop_phase(torch, np, dev))
    lap("Q30-Q31")
    per_query.update(memory_phase(torch, np, dev))
    lap("Q29")
    per_query.update(observability_phase(torch, np, dev, smi))
    lap("obs")
    per_query.update(mesh_phase(torch, np, dev))
    lap("mesh")
    per_query.update(serve_phase(torch, np, dev, smi))
    lap("serve")
    per_query.update(io_phase(torch, np, dev, smi))
    lap("io")
    per_query.update(cost_phase(torch, np, dev, smi, per_query, kres,
                                wc_batches))
    lap("cost")
    if QUERY_ROUTES["numpy"] or not QUERY_ROUTES["native"]:
        raise AssertionError(f"hybrid streams by route: {QUERY_ROUTES}")
    emit({"native_decode": {"query_streams": QUERY_ROUTES,
                            "decode_threads": _decode_threads()}})
    emit({"phase_s": phase_s})
    for q, counts in per_query.items():
        if q != "Q10" and counts["word_counts"]:
            raise AssertionError(f"{q} launched K5")
        if q != "Q22d" and counts["dfa_accept_rows"]:
            raise AssertionError(f"{q} launched the DFA kernel")

    emit({"kernels": kernels_line(kres, per_query)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
