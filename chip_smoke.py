#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

(`python3 chip_smoke.py --phase osd` builds the kernels and runs phases 3i,
3j and 3k alone, with their checks, and prints no result line;
`--phase compute` does the same for phase 3g, `--phase rgw` for 3l,
`--phase persist` for 3m, `--phase xsched` for 3n.)

Phases; any failure exits nonzero and prints no result line:

1. Build the CUDA kernels from ceph_tpu_torch/csrc (GF, crc, scoring, the
   CRUSH placement kernel, the GF fold, the hit-set kernels and the XOR
   schedule, one nvcc per source, started together) and print the seconds
   it took and what ptxas reports (registers per source, spills).
2. Hold every kernel against its plain PyTorch version on the card at the
   main path's shapes, bit-exact: the GF kernel through gf_matmul_spec
   (the registered generator's stored schedule) on RS 8+3
   (reed_sol_van) over 64 stripes of 8 x 512 KiB, and also on RS 10+4 over
   64 stripes of 10 x 512 KiB (two input groups), RS 8+3 over 16384
   stripes of 2052 bytes (single words), a random 16 x 64 matrix (the
   kernel's limits), RS 8+3 at 4096 and 12304 bytes (the column tail of
   the 16-byte path) and RS 8+3 with a zero row and a zero column; the GF
   kernel through gf_matmul_gen, whose entry derives the schedule from
   the matrix on every launch, on the same random 16 x 64 matrix, on a
   3-erasure decode matrix at 2052, 4096, 4112 and 12304 bytes (single
   words; 128-thread blocks; 256-thread blocks, with a column tail), on
   that matrix with a zero row and a zero column, and on every decode
   matrix of that code for one and two erasures and the 3-erasure one
   over the 64 stripes of 8 x 512 KiB;
   the crc kernel on 704 blocks of 512 KiB (seeds 0 and
   0xFFFFFFFF), 90112 of 4 KiB and 4096 of 2052 bytes (a length that is
   no multiple of 128 or 16).
3. Drive the main path through the entry points a user calls: a codec
   from create_erasure_code, ec_util.encode_with_hinfo over a 256 MiB
   object (64 stripes of 4 MiB, 512 KiB chunks), ec_util.decode with each
   data shard missing in turn, and decode_batch for all 11 single
   erasures.  Parity and recovered chunks are checked against the numpy
   oracle on sampled stripes, recovered objects against the original
   bytes, the hinfo ledgers against the host crc32c on sampled shards and
   the crc plain version on all of them, and the launch counters (zeroed
   just before this phase) show that every kernel ran.
3b. CRUSH placement (BASELINE config 4): the 10,000-OSD map
   build_flat_cluster(10000, 20, 10) with the replicated rule (chooseleaf
   firstn over hosts, 3 replicas) and the EC rule (set_chooseleaf_tries 5,
   chooseleaf indep over hosts, 11 slots), each with all OSDs in and with
   a rebalance weight vector (5% out, 10% at half weight).  The placement
   kernel is held bit for bit against its plain version on all 2^20
   inputs (and timed there, with its straw2 lane utilization, see phase
   4), on odd input counts (1, 31, 33, 2^20 + 17; rebalance vector), on
   the same map with a seeded weight per OSD (many distinct reciprocals;
   2^18 inputs), and also on a 64-OSD map with a CHOOSE_FIRSTN osd rule,
   on a map with an empty host bucket and on 8 seeded random
   hierarchies of 2-4 levels with random rules and weights (firstn and
   indep, leaf and not, stable 0 and 1, vary_r 0-3, descend_once 0 and
   1, numrep other than result_max); and against the host mapper on 256
   sampled inputs per rule and weight vector of the big map, x = 0 and
   2^20 - 1 among them, and on 64 inputs of each other case.  Then the
   entry point a user calls: crushtool.run --test
   --num-rep 3 --show-statistics --show-utilization over x = 0 .. 2^20 - 1
   on the map written to a JSON file, its printed counts checked against
   the placements (3 distinct OSDs per input), the kernel's launch
   counter zeroed just before it.
3c. Live PG placement: the 10,000-OSD map in an OSDMap with a replicated
   size-3 pool of 2^18 PGs (rule 0) and an EC 8+3 pool of 2^14 PGs (rule
   1), all OSDs in and again with a seeded 5% out and 2% down.  On each map
   OSDMapMapping(m) and osdmaptool.run([map file, "--test-map-pgs"]), each
   with the placement kernel's launch counter zeroed just before it; 256
   seeded PGs per pool against the host path m.pg_to_up_acting_osds, the
   tool's pg count and min/max/avg lines against the mapping's; each
   pool's launch again, held against the plain version and timed beside
   its operations bound; the update's seconds split into flattening the
   map, the pps, the kernel and the per-PG host work.
3d. The embedded cluster (BASELINE config 5's object): LocalCluster(24
   OSDs, 12 hosts) on the card with an EC pool plugin=jerasure
   reed_sol_van k=8 m=3 over hosts; 4 seeded objects of 64 MiB, each
   written (write_full), read healthy, read with one data shard's OSD down
   and with three down (then marked up again), every read exact; deep
   scrub clean, a flipped byte in one shard's MemStore reported, the read
   still exact, repair rewriting that shard, scrub clean again; one
   object's shards and hinfo/object-info xattrs equal to the same write on
   a LocalCluster(device="cpu"); the GF kernels' launch counters (zeroed
   just before the writes) above zero; object GiB/s per operation (host
   clock, median of the 4 objects) and where a write and a degraded read
   spend their time (encode, host crc, shard gather and verify, decode).
3e. The erasure-code plugin family, through the registry, the codec
   interface, the three codec tools and the cluster, each checked bit for
   bit: BASELINE config 3's layered LRC (mapping DDDDDDDD____, layers
   DDDDDDDDcc__ / DDDD______c_ / ____DDDD___c) on a 16 MiB blob, its 12
   chunks against its device="cpu" twin and the composite (4 x 8)
   matrix's host product, crc32c_blocks over the 6144 4 KiB blocks of the
   12 chunks against its plain version, every single lost chunk and every
   recoverable pair decoded; config 1 through erasure_code_benchmark
   (jerasure reed_sol_van k=4 m=2, 1 MiB, encode and decode -e 1 and -e 2,
   enough iterations for 1 s or more); LRC k=4 m=2 l=3, SHEC k=4 m=3 c=2,
   CLAY k=4 m=2 d=5 and k=8 m=4 d=11, ec_msr k=4 m=3 d=6 and k=5 m=5 d=9
   (tiled: a 25 x 25 parity matrix) on 16 MiB objects, chunks against the
   CPU twin, every single erasure and 2 seeded larger sets decoded, CLAY's
   sub-chunk repair and MSR's repair(lost, fragments) of three chunks;
   non_regression --create and --check for nine profiles, archived chunks
   against the CPU twin's; a config-3 pool and an LRC k=4 m=2 l=3 pool on
   the 24-OSD cluster, a 16 MiB object each written, read healthy,
   with one and with two OSDs down, stores against a
   LocalCluster(device="cpu").  Times are host-clock medians of 3, with
   the launches per call; the launch counters are zeroed just before the
   phase.
3f. The persistent store (BASELINE config 3's 16 MiB blobs): score_blocks
   against its plain version on (B, S) in (1, 1), (256, 3), (256, 511),
   (64, 512), (33, 513), (16, 4097), (1, 65536), (256, 65536) and (2, 64 x
   4096 + 17) (more tiles than a row's thread blocks), on zeros,
   text, random bytes and a repeated 256-byte pattern (histograms and match
   fractions bit for bit, entropy within score_kernels.ENTROPY_TOL); a
   TPUStore on the card and its device="cpu" twin, compressing (aggressive:
   snappy, lz4, zlib) and not, each given the same transactions (a 16 MiB
   object of each kind, small overwrites, xattrs, omap, a clone): block
   files, onodes and perf counters equal, every read exact, then on the
   card's store a crash() and WAL replay, a remount and a flipped byte
   (IOError, csum_read_failures 1); write and read GiB/s of a 16 MiB object
   (random, text; compression off and snappy; host clock, median of 3); a
   LocalCluster(24 OSDs, 12 hosts, store_path) with EC 8+3 over hosts, one
   64 MiB object written, read healthy and with 1 and 3 data shards' OSDs
   down, deep-scrubbed, every store mounted again and read, all stores
   against a LocalCluster(store_path, device="cpu"); score_blocks called
   in turns at (1, 65536), (256, 65536) and (33, 513), three rounds, each
   result equal to the first at its shape (the workspace reused); the host
   time of the 256 compress_decision calls of one 16 MiB random write
   beside that write's time; score_blocks timed at (1, 65536) and
   (256, 65536) alone and back to back, its kernel's own device time
   (torch.profiler), the wrapper's host time per call, beside its plain
   version (and its CUDA kernel count) and torch.bincount of the offset
   batch.  The launch counters are zeroed before the store path and again
   before the cluster; score_blocks and crc32c_blocks must launch on the
   store path, the GF kernels and crc32c_blocks on the cluster.
3g. Coded compute, coded inference and the read tier: gf_fold against its
   plain version (all-ones and gf_fingerprint rows) at the scan's
   (44, 262144, 32) and at (33, 1, 32), (7, 129, 32), (1, 3, 32) and
   (5, 1000, 64); then, the launch counters zeroed, a LocalCluster(24 OSDs,
   12 hosts) with config 5's EC 8+3 pool and four seeded 64 MiB objects (the
   last of float32 vectors), their 44 shard streams gathered from the
   stores and folded in one wave by compute.shard_eval_batch for gf_fold
   and gf_fingerprint, the results decoded in the result domain by
   ec_util.decode_many (8 data shards; data shard 0 lost; shards 0, 3 and 6
   lost) and combined, each answer against kernel.reference on the
   object's bytes and the whole scan against a device="cpu" twin
   (gf_matmul_gen must launch for the lost cases); compress_score (on
   score_blocks), count, sum, filter and dot_score on the objects read
   back, against the CPU twin; a linear scorer (131,072 x 128 float32) and
   an MLP (256 -> 3,072 -> 256) stored with inference.registry.build and
   write_full (6 data and 2 fused streams), queried with 64 queries through
   InferShardKernel.shard_eval on the OSDs' streams: the exact combine
   within INFER_RTOL of model.exact_forward, fisher.combine with data
   streams 0 and 0, 3 lost under the 0.05 budget (served within it, or
   refused where the structural bound exceeds it, as on the CPU twin);
   a TierAgent with the reference's defaults (hit sets rotated by call
   every 10,000 reads, rotate_all sealing PG by PG as the reference does,
   one bloom_seal launch a set of 8 hashes or more) over 100,000 Zipf(1.1)
   reads of 10,000 oids in 128 PGs, then the newest sealed set of 8 PGs
   queried for every oid (contains_batch, one bloom_positions launch each:
   a kernel exercise, since no OSD path queries a set so and
   bloom_positions has no caller on the main path); every decision, sealed
   set, answer and the counters against a device="cpu" twin, both rates
   printed, and the launches held to one seal a set of 8 hashes or more
   and 8 position launches; before the path, bloom_positions against its
   plain version and numpy (B in 8, 37, 1024, 65536, 65536 + 17; nhash 1,
   4, 7, 32; nbits 8, 6236, 1048573, 2^31 - 1), and bloom_seal against its
   plain version and numpy's scatter-OR on those cases cut into up to 128
   sets, on an empty set, 1 and 7 hashes, duplicates, 128 sets, a set of three
   blocks and a bitset past the shared-memory budget; after it
   positions_for on the card against numpy at 8, 1024 and 65536 hashes,
   and positions_for and one PG's insert_batch each one copy in, one
   kernel and one copy out a call (torch.profiler).  Host times: the
   scan split into gather, stage, fold, decode and combine, and its GiB/s
   of shard bytes; queries per second per model; gf_fold alone, back to
   back and its device time beside its byte bound and its plain version;
   positions_for at 1024 and 65536 hashes, the kernel alone and its own
   time; a PG's seal (the last period's median set) alone, its own time,
   queued, its host time a call and insert_batch's whole call.
3h. The monitors: three `python -m ceph_tpu_torch.mon` processes (and a
   standalone signed one) on the 10,000-OSD cluster (10 OSDs a host), their
   SQLite stores seeded with its first map (every OSD up and in), signed,
   AES-GCM sealed (the native AEAD, checked) and compressing (snappy,
   zlib).  A client Messenger waits for quorum, sets phase 3c's EC profile,
   creates a replicated size-3 pool of 128 PGs and an EC 8+3 pool of 32
   (small, see MON_REP_PGS), takes a seeded 0.5% of the OSDs out and 0.2%
   down, adds one pg-upmap-items, runs health, status and mon stat, kills
   the leader with SIGKILL, commits an osd in through the new leader and
   restarts the killed rank from its store.  Its subscription (MGetMap,
   full maps and incrementals applied to a port OSDMap) is mapped by
   OSDMapMapping on the card after the pool creates, after out and down
   and at the final epoch, against a device="cpu" twin and the host path
   on every PG; the restarted rank's map and every store's final map
   against the subscriber's.  Host-clock times: processes bound, quorum,
   mon stat round trips per second secure and signed, a commit and its
   map at the subscriber, health (first and cached), re-election, the
   restart's catch-up, the mappings.  All mon processes die in a finally.
3i. The OSD daemons and the RADOS client (BASELINE config 5 below RGW):
   one port mon and 12 port OSDs on the card in one loop, pools rgw.data
   (EC 8+3, 64 KiB stripe units) and rgw.meta (size 3); the launch
   counters zeroed, a 64 MiB PUT as 16 objects of 4 MiB in four parts in
   flight (2 trials), meta objects, every object read back, a ranged read,
   an unaligned 1 MiB overwrite, one traced 4 MiB write_full, then one and
   three OSDs killed, marked down and every object read; the counters
   read.  Checks: every read exact, every shard's hinfo against
   encode_with_hinfo on the CPU, every store's shard objects, xattrs and
   pg logs against a device="cpu" twin cluster, gf_matmul_spec launched
   once per encode-service batch (whole-object writes and the RMW's
   re-encode), crc32c_blocks twice per whole-object batch, gf_matmul_gen
   at least once per decode batch and at most once per batched read.
   Host-clock medians of the PUT's and reads' GiB/s, the traced write
   split into client, encode service and sub-writes, and (after the
   counters are read) its encode alone and the pinned staging in it.
3j. Recovery on phase 3i's cluster, its counters zeroed before a and
   before d: a. revive 3i's three victims (nothing to recover); b. kill an
   OSD holding data shards, mark it down and out, wait for clean (its
   shards decoded on gf_matmul_gen and re-encoded on gf_matmul_spec onto
   the new acting members), then one more 64 MiB PUT while it is out;
   c. revive it and mark it in (its missed shards recovered); these are
   the path `recovery`.  Then a pool of phase 3e's MSR 4/3/6 profile over
   OSDs, 8 objects of 4 MiB, and d. one more OSD killed, down and out: the
   path `recovery_msr` (MSR chunks rebuilt from d helpers' fragments).
   Checks: every object of the three pools read back exact; every shard
   object on every store against the CPU encode_with_hinfo of its object
   (bytes, and hinfo but for the RMW'd object); stores and pg logs against
   the CPU twin driven through the same history; the GF kernels at the
   paths' shapes against their plain versions; gf_matmul_gen launched at
   least once per encode-service decode batch and at most once per
   batched decode (plus, in d, once per MSR fragment: the schedule pick
   refuses the projections), in d each rebuild group on gen or, where the
   pick takes its (alpha x d) matrix (lost chunks 0, 2, 4 and 6),
   xor_sched's GF entry, at least once when such an object was rebuilt,
   gf_matmul_spec once per re-encode and per service batch of the PUT,
   crc32c_blocks twice per such batch, fewer decode dispatches in b than
   objects
   rebuilt; MSR repair on every lost chunk from at least d fragments, no
   fallback, and on primaries that ran no classic decode at most (d /
   alpha + 0.1) bytes read per byte rebuilt.  Times to clean, bytes
   rebuilt and their GiB/s, the tracer's recovery stage seconds.
3k. PG splits and coded compute and inference through the OSDs, on phase
   3j's cluster and its CPU twin (the same history), counts zeroed before
   a and before b: a. `osd pool set rgw.data pg_num 32` (from 8) with
   every object at rest, wait for clean, every object read back, one more
   4 MiB object written into a child PG (path `split`); b. phase 3g's four
   seeded 64 MiB objects written into rgw.data and scanned with them and
   every 4 MiB object there through `IoCtx.compute` (gf_fold three times,
   timed, and gf_fingerprint), then compress_score, count, sum, filter
   and dot_score on 3g's objects (the fallback); c. 3g's linear scorer and
   MLP stored with `store_model` in rgw.models (EC 8+3 at the default
   stripe unit, 2 PGs, made in 3j) and 64 queries sent exact and at the 0.05
   budget; b's linear scans and c's queries again with one and with three
   data shards' OSDs killed and marked down (path `osd_compute`).  Checks:
   the reads exact; every store's shard objects, xattrs, pg-log entries
   and `osd_meta` against the twin's; no object missing a shard after the
   split that was not missing one before it (ROADMAP C7), none short of k
   shards when healthy; every scan answer against
   kernel.reference on the written bytes (64 KiB units), gf_fold's and
   the nonlinear ones against phase 3g's library answers, all against the
   twin's; no sub-read bytes in a linear scan; rc 0 for every object but
   those short of k shards with OSDs down, which answer EAGAIN as the JAX
   OSDs do and must be among those C7 left missing a shard before the
   split; exact answers within INFER_RTOL of model.exact_forward and
   equal to the twin's, served ones within the budget or refused where
   the twin refuses, EAGAIN exactly where fewer than the model's k
   serving streams' holders are up (ROADMAP C9), and served from the
   shards when healthy; pushed-down PG waves <= gf_fold <= the length groups the
   OSDs folded, 1 <= gf_matmul_gen <= the result-domain survivor-set
   groups missing a data shard plus the service's decode requests,
   gf_matmul_spec and crc32c_blocks per the service's batches and the
   re-encodes, score_blocks on the compress_score fallback.  Times: the
   split's seconds to clean, the scan's GiB/s of shard bytes beside 3g's,
   the tracer's compute-eval, compute-decode and sub-compute span seconds
   of a scan, queries/s beside 3g's.
3l. BASELINE config 5 through the S3 gateway (path `rgw`): a fresh cluster
   of 3i's shape on the card, the port's S3Frontend on loopback over a
   port RGWLite (rgw.data EC 8+3, rgw.meta replicated), its counts zeroed
   once the pools are active.  Over HTTP, each request signed by
   sign_request (SigV4): a bucket; the 64 MiB multipart PUT as four 16
   MiB parts in flight together (one connection each), 2 trials of their
   own keys, the first warming; every object GET whole, one by a range,
   the listing; a 9 MB atomic PUT, its GET, its DELETE; 16 object-ACL
   flips (bucket-index updates).  Outside HTTP: numops add through
   IoCtx.execute on rgw.meta and on rgw.data (omap on an EC pool:
   EOPNOTSUPP), hello record_hello on rgw.data (a class write down the EC
   path), and a watch/notify round trip between two RADOS clients.  Then
   one non-primary OSD holding data shards killed and marked down, and
   every object read again.  Checks: every GET and the ranged GET against
   the written bytes, the listing's keys and sizes; the card's shard
   objects, xattrs, meta-pool omap and pg logs of both pools against a
   device="cpu" twin that replays the card's RADOS mutations (recorded at
   the gateway's IoCtxs) in each PG's log order; the kernels at the
   path's shapes against their plain versions; gf_matmul_spec = the
   encode service's whole-object batches and sheds plus its RMW batches,
   crc32c_blocks = twice the whole-object ones, 1 <= gf_matmul_gen within
   the service's decode batches and requests, all in the degraded GETs,
   and no launch in the ACL flips.  Times: the S3 PUT, GET healthy and
   with one OSD down in GiB/s beside 3i's PUT below RGW, the ranged GET,
   numops add on each pool and the notify round trip in ms.
3m. Persistence in the live cluster (paths `persist` and `persist_sweep`),
   CEPH_TPU_CRASH_INJECT armed, under one temporary directory.  (a) A fresh
   cluster of 3i's shape, every OSD on a FaultStore on the card, an EC 8+3
   pool (64 KiB units, 8 PGs) and a replicated one, the counts zeroed:
   config 5's 64 MiB as 16 objects of 4 MiB, four in flight; a small
   replicated object and its deferred overwrite on each of three OSDs
   holding data shards; the same 16 objects again with new bytes, the first
   of those OSDs power-cut (FaultStore.crash_powercut: un-synced writes
   dropped) while they are in flight, and marked down once they are done
   (ROADMAP C10); every object read
   (acked ones as written, unacked ones as their old or new bytes); the
   other two power-cut and down, every object read; the three revived on
   their directories (each remount replays its WAL, each fsid unchanged),
   wait for clean; every stored shard and hinfo against a device="cpu"
   codec's encode; deep scrub of every PG clean; one shard's byte flipped
   by inject_bitrot, the read of it refused, scrub reporting and repairing
   it, the read exact.  gf_matmul_spec = the encode service's whole-object
   batches + its re-encode batches, decode batches <=
   gf_matmul_gen <= decode requests, crc32c_blocks >= 2 x the whole-object
   batches + the stores' checksum calls of 8 or more blocks (counted at
   common/checksummer._calc_values).  (b) CrashSweep on the card over
   default_workload(24, seed 0): no violation, its trace equal to a
   device="cpu" sweep's, crc launches in the image checks; BrokenBlockStore
   and BrokenCommitStore caught.  (c) `python -m ceph_tpu_torch.tools.vstart
   --mons 1 --osds 12`: 12 TPUStore OSD processes on the card; through `python
   -m ceph_tpu_torch.tools.rados`: an EC 8+3 pool (mkpool --ec-profile), a
   64 MiB put and get, bench 2 write and seq (4 MiB, 16 threads), bench 2 seq
   --tenants 8 (read=0.7,write=0.3) at half the seq rate, scan gf_fold with
   and without CEPH_TPU_COMPUTE; one OSD process holding data shards
   SIGKILLed (a process kill, not a power cut) and marked down, the get
   exact; the OSD restarted on its store directory, the cluster clean (every
   PG active on its primary, asked over the wire), the get exact; the
   restarted OSD's perf dump through `rados tell` (journal_replays), the
   others' over a client, every EC primary with encode-service batches, no
   csum read failure, nvidia-smi listing every OSD process; vstart --stop.
   No new kernel library may appear in the build directory during 3m.
3n. The XOR-schedule kernel and the bitmatrix codecs (paths `xsched_codec`
   and `xsched`).  (a) Outside the counted paths, xor_sched's region entry
   against its plain version (output regions equal, inputs kept) on the
   compiled encode and (0, 1)-decode tapes of jerasure liberation k=4 w=7,
   blaum_roth k=4 w=6 and liber8tion k=4 (w=8) at packetsize 2048 over
   the arena of a 1 MiB object (BASELINE config 1's shape), on the arena
   of one one-stripe liberation object (1, 45, 2048: an inline encode of
   the pool's writes, the shape most of the entry's launches take) and on
   a packed batch of 512 of them; its GF entry against its
   plain version and gf_matmul_gen's plain version at MSR 4/3/6's (3 x 6)
   rebuilds (lost 0 over one 4 MiB object's fragments, lost 6 over four)
   and MSR 5/5/9's (1 x 5) projection; each timed alone, back to back and
   queued behind a spin kernel (the card's own time a call) beside its
   bound (the GF entry's operations: one 32-bit XOR a tape op
   per 32 bytes of a column) and its plain version, gf_matmul_gen at the
   same repair shapes.  (b) The counts zeroed: each technique's codec on the
   card encodes a 1 MiB object (chunks against a device="cpu" twin) and
   decodes every two-erasure pattern, one launch a call; encode and decode
   GiB/s; the port's erasure_code_benchmark (encode, decode -e 2) on it.
   (c) A fresh cluster of 3i's shape with a pool `lib.data` of liberation
   k=4 m=2 w=7 at a stripe unit of one chunk (14,336 bytes), the OSDs'
   encode-service window at XSCHED_WINDOW_MS, the counts zeroed once it is
   active: config 5's 64 MiB as 16 objects of 4 MiB four in flight, a
   burst of 512 one-stripe writes 32 in flight, a trickle of 16 spaced
   XSCHED_TRICKLE_GAP_S apart; every object read healthy and with two OSDs
   holding data shards killed and down; the two revived, clean.  Checks:
   every read exact, every stored shard and hinfo against encode_with_hinfo
   of a device="cpu" codec, the burst packed into multi-object batches and
   the trickle inline (the hot/cold router), crc32c_blocks exactly twice
   per packed batch, xor_sched_regions between the packed batches and
   those plus a launch per stripe of the inline encodes, no GF matmul
   launch on the writes, decode launches on the degraded reads.  Times:
   PUT and read GiB/s healthy and 2 down, the burst's writes/s, seconds to
   clean; the packed batch sizes, inline and packed counts.
4. Time each kernel with CUDA events (median of 20 after warm-up) beside
   its plain version and its bound, the crc kernel also at the two
   launches the main path makes (512 data and 192 parity blocks of
   512 KiB) and at 90112 blocks of 4 KiB, gf_matmul_gen also on the RS
   8+3 generator (spec's work, with the schedule derived per launch), and
   the end-to-end encode, decode and fused encode+crc in GiB/s of object data
   (host clock, median of 3); for CRUSH, the kernel per rule and weight
   vector (timed alone and back to back in phase 3b) beside its
   operations bound, its share of it, its straw2 lane utilization and
   the plain version's time, compile_rule(...)(xs)
   on 2^20 inputs in placements/s (host clock, median of 3) and the
   crushtool.run call; the GF kernels at the cluster path's shapes
   ((1, 8, 8 MiB) encode, (2048, 8, 4096) decode of 1 and 3 rows), each
   against its plain version, and the placement kernel at phase 3c's.
   Every kernels-line row carries its launches per path (codec, crushtool,
   osdmap, cluster, codecs, store, store_cluster, compute, mon, osd,
   recovery, recovery_msr, split, osd_compute, rgw, persist, persist_sweep,
   xsched_codec, xsched) and their sum;
   bloom_positions' row is timed at the tier's geometry and 65536 hashes,
   bloom_seal's at one PG's seal of the tier, xor_sched's at
   the packed batch (its launches both entries').

The line before the last is {"kernels": [...]}, the one before it each
phase's wall seconds ({"phase_seconds": {...}}); the last is
{"ok": true, "device": {...}}.  The card's name and power limit, as
nvidia-smi reports them, are printed on an earlier line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

K, M = 8, 3
CHUNK = 512 << 10
B = 64                      # stripes of the 256 MiB object
STRIPE = K * CHUNK          # 4 MiB
SEED = 20261016
RANDOM_CRUSH_MAPS = 8       # seeded random hierarchies of phase 3b
ODD_COUNTS = (1, 31, 33, (1 << 20) + 17)   # CRUSH inputs of phase 3b
EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": str(K), "m": str(M), "crush-failure-domain": "host"}
# phase 3c: a replicated size-3 pool and an EC 8+3 pool on the 10,000-OSD
# map, 3 * 2^18 + 11 * 2^14 = 966,656 PG shards, about 97 per OSD (Pacific's
# mon_target_pg_per_osd is 100); a seeded sample of each pool's PGs is held
# against the host path
OSDMAP_REP_PGS = 1 << 18
OSDMAP_EC_PGS = 1 << 14
OSDMAP_SAMPLES = 256
OUT_SHARE, DOWN_SHARE = 0.05, 0.02
# phase 3d: BASELINE config 5's object, 64 MiB into EC 8+3 over hosts, on
# 24 OSDs in 12 hosts
CLUSTER_OSDS, CLUSTER_OSDS_PER_HOST = 24, 2
CLUSTER_OBJECTS, CLUSTER_OBJECT = 4, 64 << 20

# H100 SXM published peaks: HBM3 at 3.35 TB/s, and 67 TFLOP/s of FP32
# outside the tensor cores, i.e. 33.5 T lane-instructions per second (128
# lanes per SM per clock, 2 flops each).  No integer or logic instruction
# issues faster than that lane rate, so it bounds the kernels' arithmetic.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# Instructions per 32-bit word that the kernels' arithmetic needs at
# least, counting a 3-input LOP3 once:
XTIME_OPS = 5               # shr, and, shl, imad (hi * 0x1d), lop3 (and ^)
CRC_OPS_PER_WORD = 7        # xor, 4 byte extracts, 2 lop3 for 3 xors


def spec_ops_per_word(gf_kernels, matrix) -> int:
    """The GF kernel's Horner schedule per column word, for either entry
    (the work the matrix needs, not a ladder's): xtime steps below each
    (group, row)'s top bit, one XOR per set coefficient bit, and one XOR
    of each (group, row) result into its accumulator."""
    masks, tops = gf_kernels.spec_schedule(matrix)
    set_bits = int(np.unpackbits(masks).sum())
    return (XTIME_OPS * int(np.maximum(tops, 0).sum()) + set_bits
            + int((tops >= 0).sum()))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def host_median_s(torch, fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bound(n_bytes: float, ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def varied_weight_map(rng):
    """build_flat_cluster(10000, 20, 10) with both rules of the big map and
    a seeded weight per OSD, from 1 (1/65536) to 0x40000, so that hosts and
    racks carry distinct sums."""
    from ceph_tpu_torch.tools import kernel_shapes as ks
    cmap = ks.crush_map_10k()
    small = rng.integers(1, 0x100, cmap.max_devices)
    wide = rng.integers(0x100, 0x40001, cmap.max_devices)
    per_osd = np.where(rng.random(cmap.max_devices) < 0.05, small, wide)
    ks.reweight_devices(cmap, lambda dev: int(per_osd[dev]))
    return cmap


def crush_phase(torch, dev, card: str) -> dict:
    """Phase 3b: the CRUSH placement kernel against its plain version and
    the host mapper, then crushtool.run over 2^20 inputs.  Returns what
    phase 4 needs."""
    import contextlib
    import io
    import os
    import tempfile

    from ceph_tpu_torch.crush import kernel as ck
    from ceph_tpu_torch.crush.map import (CRUSH_ITEM_NONE, build_flat_cluster)
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    from ceph_tpu_torch.crush.serialize import to_json
    from ceph_tpu_torch.ops import crush_kernels
    from ceph_tpu_torch.tools import crushtool
    from ceph_tpu_torch.tools import kernel_shapes as ks

    n = ks.CRUSH_INPUTS
    rng = np.random.default_rng(SEED)
    samples = np.concatenate([[0, n - 1], rng.choice(np.arange(1, n - 1),
                                                     254, replace=False)])

    def vs_host(cmap, ruleno, rmax, weight, got_rows, xs_host) -> int:
        bad = 0
        for x, row in zip(xs_host, got_rows):
            want = crush_do_rule(cmap, ruleno, int(x), rmax, weight)
            want = want + [CRUSH_ITEM_NONE] * (rmax - len(want))
            bad += list(row) != want
        return bad

    # the 10,000-OSD map: kernel_shapes holds every rule and weight vector
    # against the plain version on all 2^20 inputs, and times it (phase 4
    # prints the times); the plain version takes 1-5 s here (H100)
    part_t0 = time.perf_counter()
    part_s = {}
    shapes = ks.crush_shapes(dev)
    cases, worst, max_err = [], 0, 0
    for sh in shapes:
        host_bad = vs_host(sh.cmap, sh.ruleno, sh.row["result_max"],
                           sh.weight,
                           sh.got[torch.from_numpy(samples).to(dev)]
                           .cpu().numpy(), samples)
        worst = max(worst, sh.row["mismatches_vs_plain"], host_bad)
        max_err = max(max_err, sh.row["max_abs_err"])
        cases.append({"rule": sh.row["rule"], "weights": sh.row["weights"],
                      "plain_inputs": n,
                      "mismatches_vs_plain": sh.row["mismatches_vs_plain"],
                      "max_abs_err": sh.row["max_abs_err"],
                      "host_samples": len(samples),
                      "mismatches_vs_host": host_bad,
                      "plain_s": sh.row["plain_ms"] / 1e3,
                      "draws_per_input": sh.row["draws_per_input"],
                      "is_out_hashes_per_input":
                          sh.row["is_out_hashes_per_input"]})
    big = shapes[0].cmap

    # odd input counts (a lane left over in the last warp, a grid smaller
    # than the card) on the big map, and a map whose item weights differ per
    # item, so that many distinct reciprocals run
    odd = {"rebalance": ks.crush_weights(big)["rebalance"]}
    varied = varied_weight_map(np.random.default_rng(SEED + 1))
    for name, cmap, counts, weights in (
            ("10k osds, odd counts", big, ODD_COUNTS, odd),
            ("10k osds, per-item weights", varied, (1 << 18,),
             ks.crush_weights(varied))):
        for rname, ruleno, rmax in ks.CRUSH_RULES:
            prog = ck.rule_program(cmap, ruleno, rmax)
            for wname, weight in weights.items():
                dm = ck.DenseMap.from_crush_map(cmap, weight, dev)
                for count in counts:
                    xs_in = torch.arange(count, dtype=torch.int32, device=dev)
                    got = crush_kernels.crush_do_rule_batch(dm, prog, xs_in)
                    want = ck.crush_do_rule_batch_plain(dm, prog, xs_in)
                    mism = int((got != want).any(1).sum())
                    max_err = max(max_err, int((got.long() - want.long())
                                               .abs().max()))
                    tail = xs_in[-64:]
                    host_bad = vs_host(cmap, ruleno, rmax, weight,
                                       got[-64:].cpu().numpy(),
                                       tail.cpu().numpy())
                    worst = max(worst, mism, host_bad)
                    cases.append({
                        "map": name, "rule": rname, "weights": wname,
                        "distinct_recips": int(dm.recips.unique().numel()),
                        "plain_inputs": count, "mismatches_vs_plain": mism,
                        "host_samples": tail.numel(),
                        "mismatches_vs_host": host_bad})

    part_s["big_map"] = time.perf_counter() - part_t0
    # small maps: 64 OSDs with CHOOSE_FIRSTN osd, an empty host bucket, and
    # seeded random hierarchies with random tunables, so that every branch
    # of the kernel runs (stable 0, vary_r 0 and > 1, descend_once 0,
    # indep to devices, numrep other than result_max)
    small = build_flat_cluster(64, osds_per_host=4)
    small.add_simple_rule("flat", "default", "osd", mode="firstn")
    holed = build_flat_cluster(64, osds_per_host=4)
    empty = holed.add_bucket(None, holed.type_id("host"), "empty")
    holed.buckets[-1].add_item(empty.id, 0x40000)
    holed.add_simple_rule("data", "default", "host", mode="firstn")
    small_x = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    maps = [("64 osds, choose firstn osd", small, 3, small_x,
             ks.crush_weights(small)),
            ("empty host bucket", holed, 3, small_x,
             ks.crush_weights(holed))]
    for seed in range(RANDOM_CRUSH_MAPS):
        # firstn and indep, leaf and not, in turns; the chooseleaf tunables
        # in turns too (they act on chooseleaf firstn)
        k = seed // 4
        rmax = 1 + (5 * seed) % 12
        cmap, weight, _ = ks.random_crush_case(
            SEED + seed, levels=2 + k % 3, firstn=seed % 2 == 0,
            leaf=seed % 4 < 2, result_max=rmax)
        cmap.chooseleaf_stable = k % 2
        cmap.chooseleaf_vary_r = k % 4
        cmap.chooseleaf_descend_once = k // 2 % 2
        rand_x = torch.from_numpy(rng.integers(0, 2**31, 1 << 14)
                                  .astype(np.int32)).to(dev)
        maps.append((f"random {seed}", cmap, rmax, rand_x,
                     {"random": weight}))
    for name, cmap, rmax, xs_in, weights in maps:
        prog = ck.rule_program(cmap, 0, rmax)
        for wname, weight in weights.items():
            dm = ck.DenseMap.from_crush_map(cmap, weight, dev)
            got = crush_kernels.crush_do_rule_batch(dm, prog, xs_in)
            want = ck.crush_do_rule_batch_plain(dm, prog, xs_in)
            mism = int((got != want).any(1).sum())
            max_err = max(max_err, int((got.long() - want.long()).abs()
                                       .max()))
            host_bad = vs_host(cmap, 0, rmax, weight, got[:64].cpu().numpy(),
                               xs_in[:64].cpu().numpy())
            worst = max(worst, mism, host_bad)
            cases.append({"map": name, "weights": wname,
                          "program": prog._asdict(),
                          "plain_inputs": xs_in.numel(),
                          "mismatches_vs_plain": mism, "host_samples": 64,
                          "mismatches_vs_host": host_bad})
    part_s["all_cases"] = time.perf_counter() - part_t0
    print(json.dumps({"phase": "crush_vs_plain_and_host", "cases": cases,
                      "seconds": part_s}))
    check(worst == max_err == 0, "the placement kernel disagrees with its"
          " plain version or the host mapper")

    # the entry point a user calls
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(to_json(big), f)
    try:
        argv = ["-i", path, "--test", "--rule", "0", "--num-rep", "3",
                "--min-x", "0", "--max-x", str(n - 1), "--show-statistics",
                "--show-utilization"]
        out, err_out = io.StringIO(), io.StringIO()
        crush_kernels.crush_do_rule_batch.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err_out):
            rc = crushtool.run(argv)
        tool_s = time.perf_counter() - t0
        launches = crush_kernels.crush_do_rule_batch.launches
    finally:
        os.unlink(path)
    text = out.getvalue()
    stored = {}
    for line in text.splitlines():
        if line.startswith("  device "):
            dev_id = int(line.split()[1].rstrip(":"))
            stored[dev_id] = int(line.split("stored :")[1].split()[0])
    placements = ck.compile_rule(big, 0, 3)(np.arange(n))
    distinct = bool(((placements[:, 0] != placements[:, 1])
                     & (placements[:, 0] != placements[:, 2])
                     & (placements[:, 1] != placements[:, 2])).all()
                    and (placements >= 0).all()
                    and (placements < big.max_devices).all())
    counts = np.bincount(placements.ravel(), minlength=big.max_devices)
    stats_line = f"result size == 3:\t{n}/{n}"
    tool = {"phase": "crushtool", "rc": rc, "seconds": tool_s,
            "launches": launches, "inputs": n,
            "three_distinct_osds_each": distinct,
            "stored_sum": sum(stored.values()),
            "all_inputs_size_3": stats_line in text,
            "stored_matches_placements": [stored.get(d, -1) for d in
                                          range(big.max_devices)]
            == counts.tolist()}
    print(json.dumps(tool))
    check(rc == 0 and distinct and tool["stored_sum"] == 3 * n
          and tool["all_inputs_size_3"] and tool["stored_matches_placements"],
          "crushtool --test output is wrong")
    check(launches > 0, "crushtool never launched the placement kernel")
    return {"big": big, "shapes": shapes, "launches": launches,
            "max_abs_err": max_err, "crushtool_run_s": tool_s}


def crush_times(torch, dev, card: str, state: dict) -> dict:
    """Phase 4's CRUSH part: the kernel per rule and weight vector beside
    its bound and the plain version's time (timed in phase 3b by
    kernel_shapes.crush_shapes), compile_rule on 2^20 inputs and the
    crushtool.run call.  Returns the kernels line's row."""
    from ceph_tpu_torch.crush import kernel as ck
    from ceph_tpu_torch.tools import kernel_shapes as ks

    times = [{k: sh.row[k] for k in ("rule", "weights", "ms",
                                     "back_to_back_ms", "bound_ms",
                                     "bound_share", "lane_utilization",
                                     "plain_ms")}
             for sh in state["shapes"]]
    n = ks.CRUSH_INPUTS
    compile_s = host_median_s(torch, lambda: ck.compile_rule(
        state["big"], 0, 3, device=dev)(np.arange(n)))
    print(json.dumps({"crush_times": times, "compile_rule_run_s": compile_s,
                      "placements_per_s": n / compile_s,
                      "crushtool_run_s": state["crushtool_run_s"],
                      "card": card}))
    return {"launches": state["launches"],
            "max_abs_err": state["max_abs_err"], **times[0]}


def osdmap_of(cmap, rng=None):
    """The 10,000-OSD map in an OSDMap (all OSDs up and in) with the
    replicated pool on rule 0 and the EC 8+3 pool on rule 1; with `rng`, a
    seeded OUT_SHARE of the OSDs out and another DOWN_SHARE down."""
    from ceph_tpu_torch.osd import osdmap as om
    m = om.OSDMap()
    m.epoch, m.fsid = 1, "chip-smoke"
    m.crush = cmap
    m.set_max_osd(cmap.max_devices)
    for o in range(m.max_osd):
        m.osd_state[o] = om.CEPH_OSD_EXISTS | om.CEPH_OSD_UP
        m.osd_weight[o] = om.CEPH_OSD_IN
    m.create_pool("rbd", size=3, pg_num=OSDMAP_REP_PGS, crush_rule=0)
    m.erasure_code_profiles["ec83"] = dict(EC_PROFILE)
    m.create_pool("ec83", type_=om.TYPE_ERASURE, size=K + M,
                  pg_num=OSDMAP_EC_PGS, crush_rule=1,
                  erasure_code_profile="ec83")
    if rng is not None:
        order = [int(o) for o in rng.permutation(m.max_osd)]
        n_out, n_down = int(m.max_osd * OUT_SHARE), int(m.max_osd * DOWN_SHARE)
        for o in order[:n_out]:
            m.osd_weight[o] = om.CEPH_OSD_OUT
        for o in order[n_out:n_out + n_down]:
            m.osd_state[o] &= ~om.CEPH_OSD_UP
    return m


def osdmap_phase(torch, dev, card: str) -> dict:
    """Phase 3c: OSDMapMapping and osdmaptool --test-map-pgs on the
    10,000-OSD map, all in and with OSDs out and down.  Returns the launches
    and the kernel's rows at these shapes."""
    import contextlib
    import io
    import os
    import tempfile

    from ceph_tpu_torch.crush import kernel as ck
    from ceph_tpu_torch.ops import crush_kernels
    from ceph_tpu_torch.osd.osdmap import OSDMapMapping, PgId
    from ceph_tpu_torch.tools import kernel_shapes as ks
    from ceph_tpu_torch.tools import osdmaptool

    phase_t0 = time.perf_counter()
    launch = crush_kernels.crush_do_rule_batch
    rng = np.random.default_rng(SEED + 2)
    cmap = ks.crush_map_10k()
    runs, shapes, launches = [], [], 0
    for wname, m in (("all in", osdmap_of(cmap)),
                     ("out and down", osdmap_of(cmap, rng))):
        launch.launches = 0
        t0 = time.perf_counter()
        mapping = OSDMapMapping(m)
        mapping_s = time.perf_counter() - t0
        mapping_launches = launch.launches

        # the update's parts, again: the map flattened once, each pool's
        # pps and its kernel launch (timed alone, and held against the
        # plain version, which counts the draws for the bound)
        t0 = time.perf_counter()
        dm = ck.DenseMap.from_crush_map(m.crush, m.osd_weight, dev)
        torch.cuda.synchronize()
        flatten_s = time.perf_counter() - t0
        pps_s = kernel_ms = 0.0
        for pool in m.pools.values():
            t0 = time.perf_counter()
            pps = pool.all_pps()
            pps_s += time.perf_counter() - t0
            prog = ck.rule_program(m.crush, m._find_rule(pool), pool.size)
            xs = torch.from_numpy(pps.astype(np.int32)).to(dev)
            out = torch.empty((xs.numel(), pool.size), dtype=torch.int32,
                              device=dev)
            got = launch(dm, prog, xs, out=out).clone()
            stats = {}
            t0 = time.perf_counter()
            want = ck.crush_do_rule_batch_plain(dm, prog, xs, stats)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            ms = ks.alone_ms(lambda: launch(dm, prog, xs, out=out))
            kernel_ms += ms
            shapes.append({
                "weights": wname, "pool": pool.name, "inputs": xs.numel(),
                "result_max": pool.size, "ms": ms,
                "bound_ms": ks.crush_bound_ms(stats, xs.numel(), pool.size),
                "plain_ms": plain_ms,
                "mismatches_vs_plain": int((got != want).any(1).sum()),
                "max_abs_err": int((got.long() - want.long()).abs().max()),
                "draws_per_input": stats["draws"] / xs.numel()})
            del got, want, out

        # a seeded sample of each pool's PGs against the host path
        host_bad, host_pgs = 0, 0
        t0 = time.perf_counter()
        for pool in m.pools.values():
            for ps in rng.choice(pool.pg_num, OSDMAP_SAMPLES, replace=False):
                pg = PgId(pool.id, int(ps))
                host_bad += mapping.get(pg) != m.pg_to_up_acting_osds(pg)
                host_pgs += 1
        host_s = time.perf_counter() - t0

        # the tool on the map written to a file; its counts against the
        # mapping's
        fd, path = tempfile.mkstemp(suffix=".osdmap")
        with os.fdopen(fd, "wb") as f:
            f.write(m.encode())
        try:
            text = io.StringIO()
            launch.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = osdmaptool.run([path, "--test-map-pgs"])
            tool_s = time.perf_counter() - t0
            tool_launches = launch.launches
        finally:
            os.unlink(path)
        per_osd = mapping.pgs_by_osd()
        in_ids = [o for o in range(m.max_osd) if m.is_in(o)]
        counts = np.array([len(per_osd.get(o, [])) for o in in_ids])
        lo, hi = int(counts.argmin()), int(counts.argmax())
        n_pgs = sum(p.pg_num for p in m.pools.values())
        want_lines = [f"pool all pg_num {n_pgs}",
                      f"min osd.{in_ids[lo]} {int(counts[lo])}",
                      f"max osd.{in_ids[hi]} {int(counts[hi])}",
                      f"avg {float(counts.mean()):.2f}"
                      f" stddev {float(counts.std()):.2f}"]
        lines = text.getvalue().splitlines()
        tool_ok = rc == 0 and all(line in lines for line in want_lines)
        runs.append({
            "weights": wname, "pgs": n_pgs, "mapping_s": mapping_s,
            "mapping_launches": mapping_launches, "flatten_s": flatten_s,
            "pps_s": pps_s, "kernel_s": kernel_ms / 1e3,
            "kernel_share": kernel_ms / 1e3 / mapping_s,
            "per_pg_host_s": mapping_s - flatten_s - pps_s - kernel_ms / 1e3,
            "host_path_pgs": host_pgs, "host_path_mismatches": host_bad,
            "host_path_s": host_s, "osdmaptool_s": tool_s,
            "osdmaptool_launches": tool_launches, "osdmaptool_ok": tool_ok,
            "osdmaptool_lines": lines})
        launches += mapping_launches + tool_launches
        check(host_bad == 0, f"OSDMapMapping differs from the host path on"
              f" {host_bad} of {host_pgs} sampled PGs ({wname})")
        check(tool_ok, f"osdmaptool --test-map-pgs printed {lines}")
        check(mapping_launches > 0 and tool_launches > 0,
              "OSDMapMapping or osdmaptool never launched the placement"
              " kernel")
    print(json.dumps({"phase": "osdmap", "runs": runs, "kernel_shapes": shapes,
                      "seconds": time.perf_counter() - phase_t0,
                      "card": card}))
    check(all(sh["mismatches_vs_plain"] == sh["max_abs_err"] == 0
              for sh in shapes),
          "the placement kernel disagrees with its plain version")
    return {"launches": launches, "shapes": shapes}


def cluster_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3d: LocalCluster on the card, EC 8+3 over hosts: 64 MiB
    objects written, read healthy and degraded, scrubbed, corrupted and
    repaired; one object's shards and hinfo against the same write on a
    LocalCluster(device="cpu").  Returns the launches."""
    from ceph_tpu_torch.os import ObjectId, Transaction
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.rados.embedded import (HINFO_ATTR, OI_ATTR,
                                               LocalCluster, shard_collection)

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    objs = {f"obj-{i}": rng.bytes(CLUSTER_OBJECT)
            for i in range(CLUSTER_OBJECTS)}
    cluster = LocalCluster(num_osds=CLUSTER_OSDS,
                           osds_per_host=CLUSTER_OSDS_PER_HOST)
    check(cluster.device.type == "cuda", "the cluster is not on the card")
    cluster.create_erasure_pool("ecpool", EC_PROFILE)
    io = cluster.open_ioctx("ecpool")
    times = {"write_full": [], "read": [], "read_1_down": [],
             "read_3_down": []}
    exact = []

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
        return res

    for fn in wrappers.values():
        fn.launches = 0
    for name, data in objs.items():
        timed("write_full", lambda: io.write_full(name, data))
        exact.append(timed("read", lambda: io.read(name)) == data)
        acting, _primary = io.acting(io.object_pg(name))
        # one data shard lost, then three (the most RS 8+3 decodes)
        for key, lost in (("read_1_down", (0,)), ("read_3_down", (0, 3, 6))):
            for shard in lost:
                cluster.mark_osd_down(acting[shard])
            exact.append(timed(key, lambda: io.read(name)) == data)
            for shard in lost:
                cluster.mark_osd_up(acting[shard])

    # scrub, a flipped byte in one shard's store, read, repair, scrub
    name = "obj-0"
    pg = io.object_pg(name)
    acting, _primary = io.acting(pg)
    oid = ObjectId(name)
    clean_before = io.deep_scrub(name)
    store, cid = cluster.stores[acting[2]], shard_collection(pg, 2)
    buf = bytearray(store.read(cid, oid))
    buf[12345] ^= 0x01
    t = Transaction()
    t.write(cid, oid, 0, len(buf), bytes(buf))
    store.queue_transaction(t)
    found = io.deep_scrub(name)
    read_corrupt_ok = io.read(name) == objs[name]
    repaired = io.repair(name)
    clean_after = io.deep_scrub(name)
    launches = {n: fn.launches for n, fn in wrappers.items()}

    # where a write and a degraded read spend their time: the steps of
    # write_full and read, run again on obj-1
    name, data = "obj-1", objs["obj-1"]
    codec = cluster._codec(io.pool_id)
    sinfo = io._sinfo(codec)
    shards = ec_util.encode(sinfo, codec, data, range(K + M))
    pg = io.object_pg(name)
    acting, _primary = io.acting(pg)
    steps = {
        "encode_s": host_median_s(torch, lambda: ec_util.encode(
            sinfo, codec, data, range(K + M))),
        "hinfo_crc_s": host_median_s(torch, lambda: ec_util.HashInfo(
            K + M).append(0, shards)),
        "gather_and_verify_s": host_median_s(torch, lambda: io._gather_shards(
            name, pg, acting)),
        "decode_1_lost_s": host_median_s(torch, lambda: ec_util.decode(
            sinfo, codec, {i: shards[i] for i in range(1, K + M)})),
    }
    med = {key: statistics.median(v) for key, v in times.items()}
    # placement, the padding copy, the xattrs and the 11 store transactions
    steps["store_and_rest_s"] = (med["write_full"] - steps["encode_s"]
                                 - steps["hinfo_crc_s"])

    # the same write through the plain versions
    cpu = LocalCluster(num_osds=CLUSTER_OSDS,
                       osds_per_host=CLUSTER_OSDS_PER_HOST, device="cpu")
    cpu.create_erasure_pool("ecpool", EC_PROFILE)
    cpu_io = cpu.open_ioctx("ecpool")
    cpu_io.write_full(name, data)
    same = cpu_io.acting(pg) == io.acting(pg)
    for shard, osd in enumerate(acting):
        cid = shard_collection(pg, shard)
        same = same and all(
            cluster.stores[osd].read(cid, ObjectId(name))
            == cpu.stores[osd].read(cid, ObjectId(name))
            and cluster.stores[osd].getattr(cid, ObjectId(name), attr)
            == cpu.stores[osd].getattr(cid, ObjectId(name), attr)
            for attr in (HINFO_ATTR, OI_ATTR))

    gib = CLUSTER_OBJECT / (1 << 30)
    result = {
        "phase": "cluster", "osds": CLUSTER_OSDS,
        "hosts": CLUSTER_OSDS // CLUSTER_OSDS_PER_HOST,
        "objects": CLUSTER_OBJECTS, "object_bytes": CLUSTER_OBJECT,
        "reads_exact": sum(exact), "reads": len(exact),
        "scrub_clean_before": clean_before, "scrub_found": found,
        "read_with_corrupt_shard_ok": read_corrupt_ok,
        "repaired": repaired, "scrub_clean_after": clean_after,
        "same_as_cpu_cluster": same, "launches": launches,
        "seconds": times, "median_s": med,
        "gib_per_s": {key: gib / sec for key, sec in med.items()},
        "steps": steps, "seconds_in_phase": time.perf_counter() - phase_t0,
        "card": card}
    print(json.dumps(result))
    PHASE_RESULTS["cluster"] = result
    check(all(exact) and read_corrupt_ok, "a cluster read differs from the"
          " written object")
    check(clean_before == [] and clean_after == []
          and [s for s, _why in found] == [2] and repaired == [2],
          f"scrub/repair: {clean_before} {found} {repaired} {clean_after}")
    check(same, "the card's shards or hinfo differ from the CPU cluster's")
    check(launches["gf_matmul_spec"] > 0 and launches["gf_matmul_gen"] > 0,
          f"the cluster path did not launch both GF kernels: {launches}")
    return launches


# phase 3e: the erasure-code plugin family.  BASELINE config 3's layered
# LRC (k=8 m=4 l=4, which the kml shorthand cannot express) on a 16 MiB
# blob with crc32c on every 4 KiB block; config 1's benchmark; the other
# plugins on 16 MiB objects (SHEC, CLAY k=4 m=2 and LRC k=4 m=2 l=3 are
# the examples of Pacific's doc/rados/operations/erasure-code-*.rst);
# non-regression archives; LRC pools in the cluster
CONFIG3 = {"plugin": "lrc", "mapping": "DDDDDDDD____",
           "layers": json.dumps([["DDDDDDDDcc__", ""], ["DDDD______c_", ""],
                                 ["____DDDD___c", ""]])}
LRC_423 = {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}
CODEC_OBJECT = 16 << 20
CSUM_BLOCK = 4096           # BlueStore's csum block
CODEC_PROFILES = {
    "lrc k=4 m=2 l=3": LRC_423,
    "shec k=4 m=3 c=2": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    "clay k=4 m=2 d=5": {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
    "clay k=8 m=4 d=11": {"plugin": "clay", "k": "8", "m": "4", "d": "11"},
    "ec_msr k=4 m=3 d=6": {"plugin": "ec_msr", "k": "4", "m": "3", "d": "6"},
    "ec_msr k=5 m=5 d=9": {"plugin": "ec_msr", "k": "5", "m": "5", "d": "9"},
}
CODEC_SAMPLED_SETS = 2      # seeded multi-erasure sets per profile
NR_PROFILES = (
    ("jerasure", ["k=4", "m=2", "technique=reed_sol_van"]),
    ("isa", ["k=8", "m=3"]),
    ("lrc", ["k=4", "m=2", "l=3"]),
    ("lrc", ["mapping=" + CONFIG3["mapping"], "layers=" + CONFIG3["layers"]]),
    ("shec", ["k=4", "m=3", "c=2"]),
    ("clay", ["k=4", "m=2", "d=5"]),
    ("clay", ["k=8", "m=4", "d=11"]),
    ("ec_msr", ["k=4", "m=3", "d=6"]),
    ("ec_msr", ["k=5", "m=5", "d=9"]),
)
CODEC_CLUSTER_POOLS = {"config3": CONFIG3, "lrc": LRC_423}
TILED_SHAPE = (25, 70)      # past one launch's MAX_R rows and MAX_K inputs
TILED_BYTES = 1 << 14
CODEC_CLUSTER_OBJECTS = 1   # per pool: two 16 MiB objects in all


def codecs_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3e: the erasure-code plugin family on the card through the
    entry points a user calls (the registry, the codec interface, the
    three codec tools and the cluster), each checked bit for bit against
    its `device="cpu"` twin or the original bytes.  Returns the
    launches."""
    import contextlib
    import io
    import itertools
    import math
    import random
    import tempfile

    from ceph_tpu_torch.device import to_device
    from ceph_tpu_torch.ec import plan
    from ceph_tpu_torch.ec.interface import ErasureCodeError
    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.models import reed_solomon as rs
    from ceph_tpu_torch.ops import checksum as cks
    from ceph_tpu_torch.ops import crc_kernels, gf_kernels
    from ceph_tpu_torch.ops.gf import gf_matmul_ref
    from ceph_tpu_torch.tools import erasure_code_benchmark as ecb
    from ceph_tpu_torch.tools import non_regression

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    gib = CODEC_OBJECT / (1 << 30)

    def launches_now() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    def timed3(fn):
        """(host-clock median of 3 calls, first result, launches of one
        call)."""
        before = launches_now()
        times, first = [], None
        for i in range(3):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                first = res
                after = launches_now()
        return (statistics.median(times), first,
                {n: after[n] - before[n] for n in after})

    def as_bytes(chunks) -> dict:
        return {i: bytes(v) for i, v in chunks.items()}

    def pair(profile):
        codec = create_erasure_code(dict(profile))
        twin = create_erasure_code({**profile, "device": "cpu"})
        subs = [codec] + [layer.erasure_code
                          for layer in getattr(codec, "layers", [])]
        if getattr(codec, "mds", None) is not None:
            subs.append(codec.mds)
        check(all(c.device.type == "cuda" for c in subs),
              f"{profile}: a codec is not on the card")
        return codec, twin

    def recoverable(codec, twin, lost, n) -> bool:
        avail = set(range(n)) - set(lost)
        outcome = []
        for c in (codec, twin):
            try:
                c.minimum_to_decode(set(lost), avail)
                outcome.append(True)
            except ErasureCodeError:
                outcome.append(False)
        check(outcome[0] == outcome[1], f"card and CPU twin disagree on"
              f" whether {lost} is recoverable")
        return outcome[0]

    def decodes(codec, chunks, sets) -> int:
        bad = 0
        for lost in sets:
            out = codec.decode(set(lost), {i: c for i, c in chunks.items()
                                           if i not in lost})
            bad += any(bytes(out[i]) != chunks[i] for i in lost)
        return bad

    for fn in wrappers.values():
        fn.launches = 0

    # -- BASELINE config 3: layered LRC k=8 m=4 l=4, 16 MiB, 4 KiB crc --
    codec, twin = pair(CONFIG3)
    n = codec.get_chunk_count()
    want = set(range(n))
    blob = rng.bytes(CODEC_OBJECT)
    enc_s, chunks, enc_launches = timed3(
        lambda: as_bytes(codec.encode(want, blob)))
    twin_same = chunks == as_bytes(twin.encode(want, blob))
    # the composite (4 x 8) matrix of the three layers: 2 global parity
    # rows, then one local parity row per group of 4
    comp = np.zeros((4, 8), dtype=np.uint8)
    comp[:2] = rs.reed_sol_van_matrix(8, 2)
    comp[2, :4] = rs.reed_sol_van_matrix(4, 1)[0]
    comp[3, 4:] = rs.reed_sol_van_matrix(4, 1)[0]
    data = np.stack([np.frombuffer(chunks[i], np.uint8) for i in range(8)])
    composite_same = (np.array_equal(gf_matmul_ref(comp, data), np.stack(
        [np.frombuffer(chunks[i], np.uint8) for i in range(8, 12)]))
        and data.tobytes() == blob)

    def chunk_crcs(chunks):
        blocks = to_device(np.stack([np.frombuffer(chunks[i], np.uint8)
                                     for i in range(n)]), dev)
        blocks = blocks.view(-1, CSUM_BLOCK)
        return blocks, crc_kernels.crc32c_blocks(blocks, CSUM_BLOCK,
                                                 0xFFFFFFFF)

    blocks, crcs = chunk_crcs(chunks)
    crc_plain = cks.crc32c_batch(blocks, 0xFFFFFFFF)
    crc_err = int((crcs.to(torch.int64) - crc_plain.to(torch.int64))
                  .abs().max())
    host_crc = [cks.crc32c(0xFFFFFFFF, chunks[i][:CSUM_BLOCK])
                for i in range(n)]
    per_chunk = blocks.shape[0] // n
    crc_host_same = (crcs[::per_chunk].to(torch.int64) & 0xFFFFFFFF).cpu()\
        .tolist() == host_crc
    del blocks
    sets = [(i,) for i in range(n)] + list(itertools.combinations(range(n),
                                                                   2))
    fine = [s for s in sets if recoverable(codec, twin, s, n)]
    bad = decodes(codec, chunks, fine)
    local = set(codec.minimum_to_decode({0}, set(range(1, n))))
    enc_crc_s, _res, enc_crc_launches = timed3(
        lambda: chunk_crcs(as_bytes(codec.encode(want, blob)))[1].cpu())
    rep_s, rep, rep_launches = timed3(lambda: codec.decode(
        {0}, {i: chunks[i] for i in local}))
    two_s, two, two_launches = timed3(lambda: codec.decode(
        {0, 1}, {i: chunks[i] for i in range(2, n)}))
    config3 = {
        "case": "config 3", "profile": CONFIG3, "object_bytes": len(blob),
        "chunk_bytes": len(chunks[0]), "chunks_same_as_cpu": twin_same,
        "chunks_same_as_composite": composite_same,
        "crc_blocks": crcs.numel(), "crc_max_abs_err": crc_err,
        "crc_same_as_host": crc_host_same,
        "decodes": len(fine), "decodes_bad": bad,
        "unrecoverable_sets": len(sets) - len(fine),
        "local_repair_reads": sorted(local),
        "repair_ok": bytes(rep[0]) == chunks[0],
        "two_chunk_ok": all(bytes(two[i]) == chunks[i] for i in (0, 1)),
        "seconds": {"encode": enc_s, "encode_crc": enc_crc_s,
                    "local_repair": rep_s, "decode_2": two_s},
        "gib_per_s": {"encode": gib / enc_s, "encode_crc": gib / enc_crc_s,
                      "local_repair": gib / rep_s, "decode_2": gib / two_s},
        "launches_per_call": {"encode": enc_launches,
                              "encode_crc": enc_crc_launches,
                              "local_repair": rep_launches,
                              "decode_2": two_launches}}
    print(json.dumps(config3))
    check(twin_same and composite_same, "config 3: chunks differ from the"
          " CPU twin or the composite matrix's host product")
    check(crc_err == 0 and crc_host_same, "config 3: per-block crc32c"
          " differs from its plain version or the host crc")
    check(bad == 0 and config3["repair_ok"] and config3["two_chunk_ok"],
          "config 3: a decode differs from the original chunks")
    check(len(local) == 4, f"config 3: a local repair reads {sorted(local)}")

    # -- BASELINE config 1: ceph_erasure_code_benchmark, RS 4+2, 1 MiB --
    def bench(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = ecb.run(argv)
        check(rc == 0, f"erasure_code_benchmark {argv} returned {rc}")
        line = out.getvalue().strip().splitlines()[-1]
        seconds, kib = line.split("\t")
        return line, float(seconds), int(kib), \
            err.getvalue().strip().splitlines()[-1]

    random.seed(SEED)
    base = ["-p", "jerasure", "-P", "technique=reed_sol_van", "-P", "k=4",
            "-P", "m=2", "-s", "1048576"]
    config1 = []
    for label, extra in (("encode", ["-w", "encode"]),
                         ("decode -e 1", ["-w", "decode", "-e", "1"]),
                         ("decode -e 2", ["-w", "decode", "-e", "2"])):
        iters = 16
        line, seconds, kib, launches = bench(base + extra + ["-i", "16"])
        while seconds < 1.0:
            # 1.5 s worth of iterations at the last run's rate
            iters = math.ceil(iters * 1.5 / max(seconds, 1e-6))
            line, seconds, kib, launches = bench(base + extra
                                                 + ["-i", str(iters)])
        config1.append({"workload": label, "iterations": iters,
                        "line": line, "gib_per_s": kib / seconds / (1 << 20),
                        "stderr": launches})
    print(json.dumps({"case": "config 1", "runs": config1}))
    check(all(float(r["line"].split()[0]) >= 1.0 for r in config1),
          "config 1: a benchmark run took under 1 s")

    # -- the other plugins on 16 MiB objects ----------------------------------
    others = []
    for name, profile in CODEC_PROFILES.items():
        codec, twin = pair(profile)
        n = codec.get_chunk_count()
        m = codec.get_coding_chunk_count()
        want = set(range(n))
        blob = rng.bytes(CODEC_OBJECT)
        enc_s, chunks, enc_launches = timed3(
            lambda: as_bytes(codec.encode(want, blob)))
        twin_same = chunks == as_bytes(twin.encode(want, blob))
        multi = [c for r in range(2, m + 1)
                 for c in itertools.combinations(range(n), r)]
        picks = rng.choice(len(multi), min(CODEC_SAMPLED_SETS, len(multi)),
                           replace=False)
        sets = [(i,) for i in range(n)] + [multi[i] for i in sorted(picks)]
        fine = [s for s in sets if recoverable(codec, twin, s, n)]
        bad = decodes(codec, chunks, fine[1:])
        dec_s, dec, dec_launches = timed3(lambda: codec.decode(
            set(fine[0]), {i: c for i, c in chunks.items()
                           if i not in fine[0]}))
        bad += any(bytes(dec[i]) != chunks[i] for i in fine[0])
        row = {"case": name, "profile": profile, "chunks": n,
               "chunk_bytes": len(chunks[0]),
               "sub_chunks": codec.get_sub_chunk_count(),
               "chunks_same_as_cpu": twin_same, "decodes": len(fine),
               "decodes_bad": bad, "sampled_sets": [list(s) for s in sets
                                                    if len(s) > 1],
               "seconds": {"encode": enc_s, "decode_1": dec_s},
               "launches_per_call": {"encode": enc_launches,
                                     "decode_1": dec_launches}}
        repairs_ok = True
        if profile["plugin"] == "clay":
            sc = len(chunks[0]) // codec.get_sub_chunk_count()

            def clay_repair(lost):
                minimum = codec.minimum_to_decode({lost}, want - {lost})
                partial = {node: b"".join(chunks[node][off * sc:
                                                       (off + cnt) * sc]
                                          for off, cnt in ranges)
                           for node, ranges in minimum.items()}
                out = codec.decode({lost}, partial,
                                   chunk_size=len(chunks[0]))
                return bytes(out[lost]), sum(map(len, partial.values()))

            for lost in (1, n - 1):
                got, _read = clay_repair(lost)
                repairs_ok = repairs_ok and got == chunks[lost]
            rep_s, (got, read), rep_launches = timed3(lambda: clay_repair(0))
            repairs_ok = repairs_ok and got == chunks[0]
            row["repair_bytes_read"] = read
        if profile["plugin"] == "ec_msr":
            def msr_repair(lost):
                helpers = codec.minimum_to_repair(lost, want - {lost})
                frags = {h: codec.repair_project(lost, chunks[h])
                         for h in helpers}
                return codec.repair(lost, frags), sum(map(len,
                                                          frags.values()))

            for lost in (1, n - 1):
                got, _read = msr_repair(lost)
                repairs_ok = repairs_ok and got == chunks[lost]
            rep_s, (got, read), rep_launches = timed3(lambda: msr_repair(0))
            repairs_ok = repairs_ok and got == chunks[0]
            row["repair_bytes_read"] = read
        if profile["plugin"] in ("clay", "ec_msr"):
            row["repairs_ok"] = repairs_ok
            row["seconds"]["repair"] = rep_s
            row["launches_per_call"]["repair"] = rep_launches
        row["gib_per_s"] = {key: gib / sec
                            for key, sec in row["seconds"].items()}
        print(json.dumps(row))
        others.append(row)
        check(twin_same, f"{name}: chunks differ from the CPU twin")
        check(bad == 0 and repairs_ok, f"{name}: a decode or repair differs"
              " from the original chunk")

    # -- a product past one launch in rows and inputs: plan's tiling ---------
    tr, tk = TILED_SHAPE
    tmat = rng.integers(0, 256, (tr, tk), dtype=np.uint8)
    tdata = rng.integers(0, 256, (2, tk, TILED_BYTES), dtype=np.uint8)
    before = launches_now()
    tiled = plan.matmul(tmat, tdata, dev)
    after = launches_now()
    tiled_launches = {n: after[n] - before[n] for n in after}
    tiled_ok = np.array_equal(tiled, np.stack([gf_matmul_ref(tmat, d)
                                               for d in tdata]))
    blocks_expected = (math.ceil(tr / gf_kernels.MAX_R)
                       * math.ceil(tk / gf_kernels.MAX_K))
    print(json.dumps({"case": "tiled_matmul", "rows": tr, "inputs": tk,
                      "bytes_per_input": TILED_BYTES, "exact": tiled_ok,
                      "launches": tiled_launches,
                      "blocks_expected": blocks_expected}))
    check(tiled_ok, "the tiled product differs from gf_matmul_ref")
    check(tiled_launches["gf_matmul_spec"] + tiled_launches["gf_matmul_gen"]
          == blocks_expected, f"the tiled product took {tiled_launches}"
          f" launches, not {blocks_expected}")

    # -- non-regression archives ----------------------------------------------
    archives = []
    with tempfile.TemporaryDirectory() as base_dir:
        for plugin, params in NR_PROFILES:
            args = ["--plugin", plugin, "--base", base_dir]
            for param in params:
                args += ["-P", param]
            with contextlib.redirect_stderr(io.StringIO()):
                created = non_regression.run(args + ["--create"])
                checked = non_regression.run(args + ["--check"])
            nr = non_regression.NonRegression(non_regression.parse_args(args),
                                              device="cpu")
            with open(nr.content_path(), "rb") as f:
                content = f.read()
            twin = nr.codec()
            expect = as_bytes(twin.encode(set(range(twin.get_chunk_count())),
                                          content))
            files_same = True
            for i, buf in expect.items():
                with open(nr.chunk_path(i), "rb") as f:
                    files_same = files_same and f.read() == buf
            archives.append({"plugin": plugin, "params": params,
                             "create": created, "check": checked,
                             "files_same_as_cpu": files_same})
    print(json.dumps({"case": "non_regression", "archives": archives}))
    check(all(a["create"] == a["check"] == 0 and a["files_same_as_cpu"]
              for a in archives), f"non_regression: {archives}")

    # -- LRC pools in the embedded cluster ------------------------------------
    from ceph_tpu_torch.os import ObjectId
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.rados.embedded import LocalCluster, shard_collection

    clusters = {}
    for where in ("cuda", "cpu"):
        c = LocalCluster(num_osds=CLUSTER_OSDS,
                         osds_per_host=CLUSTER_OSDS_PER_HOST,
                         device=None if where == "cuda" else "cpu")
        for pool, profile in CODEC_CLUSTER_POOLS.items():
            c.create_erasure_pool(pool, {**profile,
                                         "crush-failure-domain": "host"})
        clusters[where] = c
    cluster = clusters["cuda"]
    check(cluster.device.type == "cuda", "the cluster is not on the card")
    pools = []
    for pool in CODEC_CLUSTER_POOLS:
        io_ = cluster.open_ioctx(pool)
        cpu_io = clusters["cpu"].open_ioctx(pool)
        times = {"write_full": [], "read": [], "read_1_down": [],
                 "read_2_down": []}
        exact, write_launches, read_launches = [], None, {}
        for i in range(CODEC_CLUSTER_OBJECTS):
            name, data = f"{pool}-{i}", rng.bytes(CODEC_OBJECT)
            before = launches_now()
            t0 = time.perf_counter()
            io_.write_full(name, data)
            torch.cuda.synchronize()
            times["write_full"].append(time.perf_counter() - t0)
            if write_launches is None:
                after = launches_now()
                write_launches = {k: after[k] - before[k] for k in after}
            cpu_io.write_full(name, data)
            acting, _primary = io_.acting(io_.object_pg(name))
            for key, lost in (("read", ()), ("read_1_down", (0,)),
                              ("read_2_down", (0, 9 if pool == "config3"
                                               else 2))):
                for shard in lost:
                    cluster.mark_osd_down(acting[shard])
                before = launches_now()
                t0 = time.perf_counter()
                exact.append(io_.read(name) == data)
                times[key].append(time.perf_counter() - t0)
                after = launches_now()
                read_launches.setdefault(key, {k: after[k] - before[k]
                                               for k in after})
                for shard in lost:
                    cluster.mark_osd_up(acting[shard])
        codec = cluster._codec(io_.pool_id)
        sinfo = io_._sinfo(codec)
        n = codec.get_chunk_count()
        name = f"{pool}-0"
        pg = io_.object_pg(name)
        acting, _primary = io_.acting(pg)
        shards = {s: cluster.stores[osd].read(shard_collection(pg, s),
                                              ObjectId(name))
                  for s, osd in enumerate(acting)}
        full = ec_util.decode(sinfo, codec, shards)
        steps = {
            "encode_s": host_median_s(torch, lambda: ec_util.encode(
                sinfo, codec, full, range(n))),
            "hinfo_crc_s": host_median_s(torch, lambda: ec_util.HashInfo(
                n).append(0, shards)),
            "gather_and_verify_s": host_median_s(
                torch, lambda: io_._gather_shards(name, pg, acting)),
            "decode_1_lost_s": host_median_s(torch, lambda: ec_util.decode(
                sinfo, codec, {s: b for s, b in shards.items() if s})),
        }
        med = {key: statistics.median(v) for key, v in times.items()}
        steps["store_and_rest_s"] = (med["write_full"] - steps["encode_s"]
                                     - steps["hinfo_crc_s"])
        scrub = io_.deep_scrub(f"{pool}-{CODEC_CLUSTER_OBJECTS - 1}")
        pools.append({"pool": pool, "chunks": n,
                      "stripe_chunk": sinfo.get_chunk_size(),
                      "stripes_per_object": CODEC_OBJECT
                      // sinfo.get_stripe_width(),
                      "reads_exact": sum(exact), "reads": len(exact),
                      "scrub": scrub, "median_s": med,
                      "gib_per_s": {k: gib / v for k, v in med.items()},
                      "steps": steps, "launches_per_write": write_launches,
                      "launches_per_read": read_launches})
        check(all(exact), f"cluster pool {pool}: a read differs")
        check(scrub == [], f"cluster pool {pool}: scrub found {scrub}")
    stores_same = all(
        sorted(cluster.stores[o].list_collections())
        == sorted(clusters["cpu"].stores[o].list_collections())
        and all(cluster.stores[o].read(cid, oid)
                == clusters["cpu"].stores[o].read(cid, oid)
                and cluster.stores[o].getattrs(cid, oid)
                == clusters["cpu"].stores[o].getattrs(cid, oid)
                for cid in cluster.stores[o].list_collections()
                for oid in cluster.stores[o].list_objects(cid))
        for o in cluster.stores)
    launches = launches_now()
    seconds = time.perf_counter() - phase_t0
    print(json.dumps({"case": "cluster", "osds": CLUSTER_OSDS,
                      "hosts": CLUSTER_OSDS // CLUSTER_OSDS_PER_HOST,
                      "pools": pools, "stores_same_as_cpu": stores_same}))
    print(json.dumps({"phase": "codecs", "launches": launches,
                      "seconds_in_phase": seconds, "card": card}))
    check(stores_same, "the card's LRC shards differ from the CPU cluster's")
    check(all(launches[k] > 0 for k in ("gf_matmul_spec", "gf_matmul_gen",
                                        "crc32c_blocks")),
          f"a kernel never launched on the codecs path: {launches}")
    return launches


# phase 3f: the persistent store.  BASELINE config 3's 16 MiB blob in
# TPUStores that compress (aggressive, each of snappy, lz4 and zlib) and in
# one that does not; the store-backed cluster in config 5's shape.
STORE_OBJECT = 16 << 20
STORE_ALGS = ("snappy", "lz4", "zlib", "none")
STORE_KINDS = ("zeros", "text", "random", "pattern")
SCORE_SHAPES = ((1, 1), (256, 3), (256, 511), (64, 512), (33, 513),
                (16, 4097), (1, 65536), (256, 65536), (2, 64 * 4096 + 17))
STORE_CLUSTER_OBJECTS = 1
# score_blocks called in turns at these shapes (its workspace reused)
SCORE_REPEAT_SHAPES = ((1, 65536), (256, 65536), (33, 513))
SCORE_REPEAT_ROUNDS = 3


def store_kind(kind: str, size: int, rng) -> bytes:
    """`size` bytes of one data kind: zeros, English-like text, random
    bytes, or a 256-byte random pattern repeated."""
    if kind == "zeros":
        return bytes(size)
    if kind == "random":
        return rng.bytes(size)
    if kind == "text":
        from ceph_tpu_torch.tools.kernel_shapes import score_text

        return score_text(size, rng).tobytes()
    return (rng.bytes(256) * (size // 256 + 1))[:size]


def store_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3f: score_blocks against its plain version on the card; the
    TPUStore on the card against its device="cpu" twin (block files and
    onodes byte-equal, crash and WAL replay, bitrot); the store-backed
    LocalCluster against a CPU twin, degraded reads, scrub and a remount;
    host-clock times.  Returns the launches per path and the kernel's
    check and times for the kernels line."""
    import shutil
    import tempfile

    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.compressor import scoring
    from ceph_tpu_torch.os import ObjectId, Transaction
    from ceph_tpu_torch.os.tpustore import TPUStore
    from ceph_tpu_torch.ops import score_kernels
    from ceph_tpu_torch.rados.embedded import (HINFO_ATTR, OI_ATTR,
                                               LocalCluster)
    from ceph_tpu_torch.tools.kernel_shapes import (alone_ms, back_to_back_ms,
                                                    host_us, kernel_ms,
                                                    score_ops)

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        # -- 1. the kernel against its plain version ------------------------
        worst, cases = 0.0, 0
        for b, s in SCORE_SHAPES:
            for kind in STORE_KINDS:
                blocks = torch.from_numpy(np.frombuffer(
                    store_kind(kind, b * s, rng), np.uint8).reshape(b, s)
                    .copy()).to(dev)
                hist, ent, match = score_kernels.score_blocks(blocks)
                p_hist, p_ent, p_match = score_kernels.score_blocks_plain(
                    blocks)
                check(torch.equal(hist, p_hist) and torch.equal(
                    match.view(torch.int32), p_match.view(torch.int32)),
                    f"score_blocks disagrees with its plain version at"
                    f" {(b, s)} on {kind} data")
                worst = max(worst, float((ent - p_ent).abs().max()))
                cases += 1
        check(worst <= score_kernels.ENTROPY_TOL,
              f"score_blocks' entropy is off by {worst}")
        print(json.dumps({"phase": "store_kernel_vs_plain", "cases": cases,
                          "shapes": SCORE_SHAPES, "kinds": STORE_KINDS,
                          "entropy_max_abs_err": worst,
                          "entropy_tol": score_kernels.ENTROPY_TOL}))

        # calls in turns at three shapes on the one workspace: each result
        # equals the first call's at its shape
        repeat = {(b, s): torch.from_numpy(np.frombuffer(
            store_kind("random", b * s, rng), np.uint8).reshape(b, s)
            .copy()).to(dev) for b, s in SCORE_REPEAT_SHAPES}
        first, same = {}, dict.fromkeys(repeat, 0)
        for _ in range(SCORE_REPEAT_ROUNDS):
            for shape, blocks in repeat.items():
                got = score_kernels.score_blocks_packed(blocks)
                if shape in first:
                    same[shape] += torch.equal(got, first[shape])
                else:
                    first[shape] = got
        print(json.dumps({"phase": "store_kernel_repeat",
                          "rounds": SCORE_REPEAT_ROUNDS,
                          "equal_to_first": {f"{b}x{s}": n for (b, s), n
                                             in same.items()}}))
        check(all(n == SCORE_REPEAT_ROUNDS - 1 for n in same.values()),
              "score_blocks gave another result on a repeated call")
        del repeat, first

        # -- 2. the store on the card against its CPU twin -------------------
        objs = {kind: store_kind(kind, STORE_OBJECT, rng)
                for kind in STORE_KINDS}
        small = rng.bytes(4096)

        def config(alg):
            cfg = Config()
            if alg != "none":
                cfg.set_val("bluestore_compression_mode", "aggressive")
                cfg.set_val("bluestore_compression_algorithm", alg)
            return cfg

        def drive(store):
            """The same transactions on any store; returns the reads."""
            t = Transaction()
            t.create_collection("1.0_head")
            store.queue_transaction(t)
            for kind, data in objs.items():
                t = Transaction()
                t.write("1.0_head", ObjectId(kind), 0, len(data), data)
                store.queue_transaction(t)
            for kind in objs:          # small overwrites: deferred if raw
                t = Transaction()
                t.write("1.0_head", ObjectId(kind), 12345, len(small), small)
                t.setattr("1.0_head", ObjectId(kind), "_", kind.encode())
                t.omap_setkeys("1.0_head", ObjectId(kind), {"k": small[:8]})
                store.queue_transaction(t)
            t = Transaction()
            t.clone("1.0_head", ObjectId("text"), ObjectId("text-clone"))
            store.queue_transaction(t)
            return {str(o): store.read("1.0_head", o)
                    for o in store.list_objects("1.0_head")}

        def state(store):
            store._block.flush()
            with open(store._block_path, "rb") as f:
                block = f.read()
            onodes = list(store._kv.get_iterator("O"))
            return block, onodes, {k: v for k, v in
                                   store.perf_counters().items()}

        want = {k: bytearray(v) for k, v in objs.items()}
        for v in want.values():
            v[12345:12345 + len(small)] = small
        want = {k: bytes(v) for k, v in want.items()}
        want["text-clone"] = want["text"]
        store_runs = {}
        for fn in wrappers.values():
            fn.launches = 0
        for alg in STORE_ALGS:
            run = {}
            for devname in ("cuda", "cpu"):
                path = f"{tmp}/{alg}-{devname}"
                st = TPUStore(path, config=config(alg), device=devname)
                st.mkfs()
                st.mount()
                t0 = time.perf_counter()
                reads = drive(st)
                torch.cuda.synchronize()
                run[devname] = (time.perf_counter() - t0, reads == want,
                                state(st))
                if devname == "cpu":
                    st.umount()
                    continue
                # crash before the lazy deferred flush, replay, remount
                st.crash()
                st = TPUStore(path, config=config(alg), device=devname)
                st.mount()
                replayed = st.perf_counters()
                after_crash = {str(o): st.read("1.0_head", o)
                               for o in st.list_objects("1.0_head")} == want
                st.umount()
                st = TPUStore(path, config=config(alg), device=devname)
                st.mount()
                after_remount = {str(o): st.read("1.0_head", o)
                                 for o in st.list_objects("1.0_head")} == want
                # one flipped byte inside the random object's first blob
                blob = st._get_onode("1.0_head", ObjectId("random")).blobs[0]
                st.umount()
                with open(f"{path}/block", "r+b") as f:
                    f.seek(blob.offset + 100)
                    byte = f.read(1)
                    f.seek(blob.offset + 100)
                    f.write(bytes([byte[0] ^ 0x20]))
                st = TPUStore(path, config=config(alg), device=devname)
                st.mount()
                try:
                    st.read("1.0_head", ObjectId("random"))
                    caught = False
                except IOError:
                    caught = True
                run["replay"] = {
                    "journal_replayed_entries":
                        replayed["journal_replayed_entries"],
                    "reads_after_crash_exact": after_crash,
                    "reads_after_remount_exact": after_remount,
                    "bitrot_raises": caught,
                    "csum_read_failures":
                        st.perf_counters()["csum_read_failures"]}
                st.umount()
            cuda_state, cpu_state = run["cuda"][2], run["cpu"][2]
            store_runs[alg] = {
                "reads_exact": run["cuda"][1] and run["cpu"][1],
                "block_file_equal": cuda_state[0] == cpu_state[0],
                "onodes_equal": cuda_state[1] == cpu_state[1],
                "perf_equal": cuda_state[2] == cpu_state[2],
                "stored_bytes": len(cuda_state[0]),
                "deferred_writes": cuda_state[2]["deferred_writes"],
                "drive_s": {"cuda": run["cuda"][0], "cpu": run["cpu"][0]},
                **run["replay"]}
        store_launches = {n: fn.launches for n, fn in wrappers.items()}
        print(json.dumps({"phase": "store", "object_bytes": STORE_OBJECT,
                          "kinds": STORE_KINDS, "runs": store_runs,
                          "launches": store_launches}))
        for alg, r in store_runs.items():
            check(r["reads_exact"] and r["block_file_equal"]
                  and r["onodes_equal"] and r["perf_equal"],
                  f"the card's {alg} store differs from its CPU twin: {r}")
            check(r["reads_after_crash_exact"]
                  and r["reads_after_remount_exact"],
                  f"the {alg} store lost data across crash/remount: {r}")
            check(r["bitrot_raises"] and r["csum_read_failures"] == 1,
                  f"the {alg} store missed a flipped byte: {r}")
        check(store_runs["none"]["deferred_writes"] > 0
              and store_runs["none"]["journal_replayed_entries"] > 0,
              "the uncompressed store took no deferred write or replay")
        check(store_launches["score_blocks"] > 0
              and store_launches["crc32c_blocks"] > 0,
              f"a kernel never launched on the store path: {store_launches}")

        # -- 3. store times: a 16 MiB object, compression off and on ---------
        times = {}
        for alg in ("none", "snappy"):
            path = f"{tmp}/times-{alg}"
            st = TPUStore(path, config=config(alg), device="cuda")
            st.mkfs()
            st.mount()
            t = Transaction()
            t.create_collection("c")
            st.queue_transaction(t)
            for kind in ("random", "text"):
                data = objs[kind]

                def write(kind=kind, data=data, st=st):
                    t = Transaction()
                    t.write("c", ObjectId(kind), 0, len(data), data)
                    st.queue_transaction(t)

                w = host_median_s(torch, write)
                r = host_median_s(torch, lambda st=st, kind=kind: st.read(
                    "c", ObjectId(kind)))
                times[f"{alg}_{kind}"] = {
                    "write_s": w, "read_s": r,
                    "write_gib_per_s": STORE_OBJECT / (1 << 30) / w,
                    "read_gib_per_s": STORE_OBJECT / (1 << 30) / r}
            st.umount()
        # the scoring a compressing write of the random object makes: one
        # compress_decision per 64 KiB span, on the same arrays
        spans = np.frombuffer(objs["random"], np.uint8).reshape(-1, 1, 65536)

        def score_spans() -> float:
            total = 0.0
            for span in spans:
                t0 = time.perf_counter()
                scoring.compress_decision(span, 0.875, device=dev)
                total += time.perf_counter() - t0
            return total

        score_spans()
        scoring_s = statistics.median(score_spans() for _ in range(3))
        times["snappy_random"]["scoring_s"] = scoring_s
        times["snappy_random"]["scoring_share"] = (
            scoring_s / times["snappy_random"]["write_s"])
        print(json.dumps({"phase": "store_times", "object_bytes":
                          STORE_OBJECT, "times": times, "card": card}))

        # -- 4. the store-backed cluster --------------------------------------
        cobjs = {f"obj-{i}": rng.bytes(CLUSTER_OBJECT)
                 for i in range(STORE_CLUSTER_OBJECTS)}
        for fn in wrappers.values():
            fn.launches = 0
        cl = LocalCluster(num_osds=CLUSTER_OSDS,
                          osds_per_host=CLUSTER_OSDS_PER_HOST,
                          store_path=f"{tmp}/cluster")
        check(cl.device.type == "cuda" and all(
            s.device.type == "cuda" for s in cl.stores.values()),
            "the store-backed cluster is not on the card")
        cl.create_erasure_pool("ecpool", EC_PROFILE)
        io = cl.open_ioctx("ecpool")
        ctimes = {"write_full": [], "read": [], "read_1_down": [],
                  "read_3_down": []}
        exact = []

        def ctimed(key, fn):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ctimes[key].append(time.perf_counter() - t0)
            return res

        for name, data in cobjs.items():
            ctimed("write_full", lambda: io.write_full(name, data))
            exact.append(ctimed("read", lambda: io.read(name)) == data)
            acting, _primary = io.acting(io.object_pg(name))
            for key, lost in (("read_1_down", (0,)),
                              ("read_3_down", (0, 3, 6))):
                for shard in lost:
                    cl.mark_osd_down(acting[shard])
                exact.append(ctimed(key, lambda: io.read(name)) == data)
                for shard in lost:
                    cl.mark_osd_up(acting[shard])
        scrub = [io.deep_scrub(name) for name in cobjs]
        cl.shutdown()
        for osd in cl.stores:      # every store mounted again on its disk
            st = TPUStore(f"{tmp}/cluster/osd.{osd}", device="cuda")
            st.mount()
            cl.stores[osd] = st
        remount_exact = all(io.read(name) == data
                            for name, data in cobjs.items())
        cluster_launches = {n: fn.launches for n, fn in wrappers.items()}

        cpu = LocalCluster(num_osds=CLUSTER_OSDS,
                           osds_per_host=CLUSTER_OSDS_PER_HOST,
                           store_path=f"{tmp}/cluster-cpu", device="cpu")
        cpu.create_erasure_pool("ecpool", EC_PROFILE)
        cpu_io = cpu.open_ioctx("ecpool")
        for name, data in cobjs.items():
            cpu_io.write_full(name, data)
        same = True
        for osd, st in cl.stores.items():
            twin = cpu.stores[osd]
            same = same and st.list_collections() == \
                twin.list_collections()
            for cid in st.list_collections():
                same = same and st.list_objects(cid) == \
                    twin.list_objects(cid)
                for oid in st.list_objects(cid):
                    same = same and st.read(cid, oid) == \
                        twin.read(cid, oid) and all(
                            st.getattr(cid, oid, a) == twin.getattr(
                                cid, oid, a) for a in (HINFO_ATTR, OI_ATTR))
        cl.shutdown()
        cpu.shutdown()
        med = {k: statistics.median(v) for k, v in ctimes.items()}
        gib = CLUSTER_OBJECT / (1 << 30)
        print(json.dumps({
            "phase": "store_cluster", "osds": CLUSTER_OSDS,
            "objects": STORE_CLUSTER_OBJECTS, "object_bytes": CLUSTER_OBJECT,
            "reads_exact": sum(exact), "reads": len(exact),
            "scrub": scrub, "remount_reads_exact": remount_exact,
            "same_as_cpu_cluster": same, "launches": cluster_launches,
            "seconds": ctimes, "median_s": med,
            "seconds_in_phase_so_far": time.perf_counter() - phase_t0,
            "gib_per_s": {k: gib / v for k, v in med.items()},
            "card": card}))
        check(all(exact) and remount_exact,
              "a store-backed cluster read differs from the written object")
        check(scrub == [[]] * STORE_CLUSTER_OBJECTS,
              f"deep scrub on the store-backed cluster: {scrub}")
        check(same, "the card's stores differ from the CPU cluster's")
        check(cluster_launches["gf_matmul_spec"] > 0
              and cluster_launches["gf_matmul_gen"] > 0
              and cluster_launches["crc32c_blocks"] > 0,
              f"a kernel never launched on the store-backed cluster:"
              f" {cluster_launches}")

        # -- 5. kernel times -------------------------------------------------
        ktimes = {}
        for b, s in ((1, 65536), (256, 65536)):
            blocks = torch.from_numpy(np.frombuffer(
                store_kind("text", b * s, rng), np.uint8).reshape(b, s)
                .copy()).to(dev)
            offset = (blocks.to(torch.int64) + 256 * torch.arange(
                b, device=dev)[:, None]).reshape(-1)
            plain_launches = None
            try:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    score_kernels.score_blocks_plain(blocks)
                    torch.cuda.synchronize()
                plain_launches = sum(
                    1 for e in prof.events()
                    if getattr(e, "device_type", None) is not None
                    and str(e.device_type).endswith("CUDA"))
            except (RuntimeError, AssertionError) as e:
                print(json.dumps({"profiler_failed": repr(e)}))
            n_bytes = b * s + b * (256 * 4 + 8)
            b_ms, by = bound(n_bytes, score_ops(b, s))
            ktimes[f"{b}x{s}"] = {
                "ms": alone_ms(lambda: score_kernels.score_blocks(blocks)),
                "back_to_back_ms": back_to_back_ms(
                    lambda: score_kernels.score_blocks(blocks)),
                # the kernel's own device time, and the wrapper's host time
                "kernel_ms": kernel_ms(
                    lambda: score_kernels.score_blocks(blocks),
                    "score_kernel"),
                "host_us": host_us(
                    lambda: score_kernels.score_blocks(blocks)),
                # the store's call: the packed rows, no views
                "packed_host_us": host_us(
                    lambda: score_kernels.score_blocks_packed(blocks)),
                "plain_ms": alone_ms(
                    lambda: score_kernels.score_blocks_plain(blocks),
                    reps=5, warmup=1),
                "plain_kernel_launches": plain_launches,
                "bincount_ms": alone_ms(lambda: torch.bincount(
                    offset, minlength=256 * b)),
                "bound_ms": b_ms, "bound_by": by,
                "bytes_bound_ms": bound(n_bytes, 0)[0]}
            row = ktimes[f"{b}x{s}"]
            row["share_back_to_back"] = b_ms / row["back_to_back_ms"]
            row["share_kernel"] = (b_ms / row["kernel_ms"]
                                   if row["kernel_ms"] else None)
        print(json.dumps({"phase": "store_kernel_times", "times": ktimes,
                          "card": card}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"phase": "store_done",
                      "seconds_in_phase": time.perf_counter() - phase_t0}))
    return {"store": store_launches, "store_cluster": cluster_launches,
            "score_err": worst, "score_times": ktimes}


# phase 3g: coded compute, coded inference and the read tier on the card.
# Config 5's shape (24 MemStore OSDs in 12 hosts, reed_sol_van 8+3 over
# hosts); 4 seeded 64 MiB objects, the last of them float32 vectors; the scan
# folds every object's 11 shard streams (8 MiB each, 262,144 rows of 32
# lanes) in one wave.
SCAN_OBJECTS = 4
SCAN_LOST = {"data": (), "1_lost": (0,), "3_lost": (0, 3, 6)}
FOLD_SHAPES = ((33, 1, 32), (7, 129, 32), (1, 3, 32), (5, 1000, 64))
# two models in the 8+3 pool, k_model = 6 data and m = 2 fused streams: a
# linear scorer with a 131,072 x 128 float32 table (64 MiB) and a 2-layer
# MLP (256 -> 3,072 -> 256); 64 queries each
MODELS = (("linear", 128, 131072, 0), ("mlp", 256, 256, 3072))
MODEL_M, MODEL_QUERIES, MODEL_BUDGET = 2, 64, 0.05
# the exact combine sums float32 in another order on the card: a relative
# norm of 1e-5 is over a hundred times what a reordered 128- or 3072-term
# float32 sum moves
INFER_RTOL = 1e-5
# the tier: 100,000 Zipf(1.1) reads over 10,000 oids in 128 PGs, hit sets
# rotated every 10,000 reads
TIER_READS, TIER_OIDS, TIER_PGS, TIER_ROTATE = 100_000, 10_000, 128, 10_000
TIER_OPTIONS = ("osd_tier_enable", "osd_hit_set_count", "osd_hit_set_period",
                "osd_hit_set_target_size", "osd_hit_set_bloom_fpp",
                "osd_hit_set_type", "osd_tier_promote_min_recency",
                "osd_tier_cache_bytes", "osd_tier_promote_max_inflight",
                "osd_tier_promote_backoff")


# the hit-set hash kernel against its plain version and numpy: batches on
# both sides of a launch's threads, nhash up to bloom_geometry's 32, nbits
# from 8 to 2^31 - 1 (mostly not powers of two)
BLOOM_BATCHES = (8, 37, 1024, 65536, 65536 + 17)
BLOOM_NHASH = (1, 4, 7, 32)
BLOOM_NBITS = (8, 6236, 1048573, (1 << 31) - 1)
# lane instructions a position needs at least: hash32_2's three mixes of
# nine steps (an IADD3, a shift and a LOP3 each) and its seed XOR, then
# the magic-reciprocal remainder (IMAD.HI, two shifts, an add, a subtract,
# an IMAD)
BLOOM_OPS_PER_POSITION = 3 * 9 * 3 + 1 + 6
# the seal against its plain version and numpy: each BLOOM_* case cut into
# up to SEAL_MAX_SETS sets (at most SEAL_MAX_BYTES of rows a case), then
# edge cases at the tier's geometry; SEAL_SHARED_BITS is the largest bitset
# the kernel builds in shared memory (227 KB)
SEAL_MAX_SETS = 128
SEAL_MAX_BYTES = 64 << 20
SEAL_SHARED_BITS = 232448 // 4 * 32
# a seal's lane instructions a position at least: the hash's, then the
# bit's shift, its word's address and the OR
SEAL_OPS_PER_POSITION = BLOOM_OPS_PER_POSITION + 3
TIER_QUERY_PGS = 8          # PGs whose newest sealed set 3g queries


def scan_objects(size: int) -> dict:
    """Phase 3g's seeded scan objects of `size` bytes, the last of them
    float32 vectors (phase 3k writes them into the OSDs' pool)."""
    rng = np.random.default_rng(SEED + 7)
    objs = {f"scan-{i}": rng.bytes(size) for i in range(SCAN_OBJECTS - 1)}
    objs[f"scan-{SCAN_OBJECTS - 1}"] = rng.standard_normal(
        size // 4).astype("<f4").tobytes()
    return objs


def nonlinear_cases() -> list:
    """(kernel, object, args) of the nonlinear kernels phases 3g and 3k
    evaluate on the scan objects."""
    floats = f"scan-{SCAN_OBJECTS - 1}"
    query = np.random.default_rng(SEED).standard_normal(16).tolist()
    return [
        ("compress_score", "scan-0", {}),
        ("compress_score", floats, {"block": 65536}),
        ("count", floats, {"record": 8, "cmp": "lt", "value": 1 << 62}),
        ("sum", floats, {"record": 8, "off": 0, "len": 4}),
        ("filter", floats, {"record": 4, "cmp": "gt", "value": 0x40800000,
                            "limit": 64}),
        ("dot_score", floats, {"dim": 16, "query": query})]


def zipf_indices(theta: float, n: int, count: int,
                 seed: int = 0) -> np.ndarray:
    """Deterministic Zipf(theta) sample of `count` object ranks in [0, n)
    (a copy of ceph_tpu/tools/rados.py zipf_indices)."""
    ranks = np.arange(1, max(int(n), 1) + 1, dtype=np.float64)
    weights = ranks ** -float(theta)
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    u = np.random.default_rng(seed).random(int(count))
    return np.searchsorted(cdf, u).astype(np.int64)


def cut_sets(h: np.ndarray, nbits: int, seed: int) -> list:
    """`h` cut at seeded points into as many as SEAL_MAX_SETS sets (about
    16 hashes a set, at most SEAL_MAX_BYTES of bitsets in all)."""
    n = max(1, min(SEAL_MAX_SETS, h.size // 16,
                   SEAL_MAX_BYTES // ((nbits + 7) // 8)))
    cuts = np.sort(np.random.default_rng(seed).integers(0, h.size + 1,
                                                        n - 1))
    return np.split(h, cuts)


def seal_numpy_words(hitset, sets, nbits: int, nhash: int) -> tuple:
    """The reference BloomHitSet.insert_batch's bits for each set (numpy
    positions scattered with np.bitwise_or.at), as the flat indices and
    int32 values of the nonzero 32-bit words of [S, ceil(nbits / 32)]
    rows."""
    nwords = (nbits + 31) // 32
    parts, bits = [], []
    for row, h in enumerate(sets):
        if h.size:
            pos = hitset.bloom_positions(h, nbits, nhash).reshape(-1)
            parts.append(row * nwords + (pos >> 5).astype(np.int64))
            bits.append(np.left_shift(np.uint32(1), pos & np.uint32(31)))
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    words, inverse = np.unique(np.concatenate(parts), return_inverse=True)
    values = np.zeros(words.size, dtype=np.uint32)
    np.bitwise_or.at(values, inverse, np.concatenate(bits))
    return words, values.view(np.int32)


def staged_sets(torch, dev, sets) -> tuple:
    """(hashes, offsets) of `sets` as the seal takes them on `dev`, and
    the largest set."""
    sizes = [h.size for h in sets]
    offsets = np.zeros(len(sets) + 1, dtype=np.int32)
    np.cumsum(sizes, out=offsets[1:])
    flat = np.concatenate(sets) if sets else np.zeros(0, np.uint32)
    return (torch.from_numpy(flat.astype(np.uint32).view(np.int32)).to(dev),
            torch.from_numpy(offsets).to(dev), max(sizes, default=0))


def period_sets(trace, pgs, start: int) -> list:
    """Each PG's unique oid hashes of the TIER_ROTATE reads from `start`,
    PG by PG as the tier's stacks hold them: one rotate_all's sets."""
    from ceph_tpu_torch.osd import hitset

    per_pg: dict = {}
    for i in trace[start:start + TIER_ROTATE]:
        per_pg.setdefault(pgs[i], {})[hitset.hash_oid(f"obj{i}")] = None
    return [np.fromiter(d, dtype=np.uint32, count=len(d))
            for d in per_pg.values()]


def profile_calls(torch, fn, kernel: str, calls: int = 8) -> list:
    """The CUDA work of `calls` calls of fn from torch.profiler, call by
    call: the device events in start order cut at each host-to-device copy
    (a call's first), named "copy" or "kernel" (`kernel` in the name) or
    by their own name.  The first cut is dropped, since a profile's first
    events can go missing (one call lost its first events and the next
    call whole in one run of five)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_card = sorted(
        (e.time_range.start, e.name) for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA"))
    cut, cur = [], None
    for _start, name in on_card:
        if name.startswith("Memcpy HtoD"):
            cur = []
            cut.append(cur)
        if cur is not None:
            cur.append("kernel" if kernel in name else "copy"
                       if name.startswith(("Memcpy", "Memset")) else name)
    return cut[1:]


def drive_tier(agent, trace, pgs, sizes, rotations=None) -> list:
    """The OSD read path's tier calls for each read of `trace`, hit sets
    rotated every TIER_ROTATE reads; returns every decision.  Each
    rotate_all's host seconds go on `rotations`."""
    log = []
    for n, i in enumerate(trace):
        oid, pg = f"obj{i}", pgs[i]
        agent.record_read(pg, oid)
        hc = agent.hit_count(pg, oid)
        data = agent.lookup(pg, oid)
        wants = began = False
        if data is None:
            wants = agent.wants_promote(pg, oid, hc)
            if wants:
                began = agent.begin_promote(pg, oid)
                if began:
                    agent.end_promote(pg, oid, bytes(sizes[i]))
        log.append((hc, data is not None, wants, began))
        if (n + 1) % TIER_ROTATE == 0:
            t0 = time.perf_counter()
            agent.rotate_all()
            if rotations is not None:
                rotations.append(time.perf_counter() - t0)
            log.append([(pg, seq, s.to_dict())
                        for pg, seq, s in agent.pop_sealed()])
    return log


def compute_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3g: gf_fold against its plain version; the pushdown scan of
    four 64 MiB EC 8+3 objects (gf_fold and gf_fingerprint over the wave
    of 44 shard streams, results decoded on three survivor sets) against
    the host oracle and the CPU twin; the nonlinear kernels; two stored
    models queried through the shard kernel; the tier agent against its
    CPU twin over a Zipf trace; host-clock times.  Returns the launches,
    the kernel's check and its times."""
    from ceph_tpu_torch import compute
    from ceph_tpu_torch.common import options
    from ceph_tpu_torch.compute import kernels as ckernels
    from ceph_tpu_torch.ec import plan
    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.inference import fisher, model, registry
    from ceph_tpu_torch.inference import kernels as ikernels
    from ceph_tpu_torch.ops import bloom_kernels, fold_kernels
    from ceph_tpu_torch.os import ObjectId
    from ceph_tpu_torch.osd import ec_util, hitset
    from ceph_tpu_torch.osd.tier import TierAgent
    from ceph_tpu_torch.rados.embedded import LocalCluster, shard_collection
    from ceph_tpu_torch.tools.kernel_shapes import (alone_ms, back_to_back_ms,
                                                    host_us, kernel_ms,
                                                    queued_ms)

    phase_t0 = time.perf_counter()
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    n = K + M
    stream = CLUSTER_OBJECT // K
    rows, lanes = stream // compute.DEFAULT_LANES, compute.DEFAULT_LANES
    fp = ckernels.GfFingerprint()

    def weights_of(kind: str, r: int):
        if kind == "gf_fold":
            return None
        return torch.from_numpy(np.array(fp.row_weights(r)).reshape(-1)) \
            .to(dev)

    # -- 1. the kernel against its plain version -------------------------
    wave = torch.randint(0, 256, (SCAN_OBJECTS * n, rows, lanes),
                         dtype=torch.uint8, device=dev, generator=gen)
    fold_cases = {}
    for shape in ((SCAN_OBJECTS * n, rows, lanes), *FOLD_SHAPES):
        d = wave if shape == tuple(wave.shape) else torch.randint(
            0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        for kind in ("gf_fold", "gf_fingerprint"):
            w = weights_of(kind, shape[1])
            a = fold_kernels.gf_fold(w, d)
            b = fold_kernels.gf_fold_plain(w, d)
            fold_cases[f"{kind} {list(shape)}"] = int(
                (a.to(torch.int16) - b.to(torch.int16)).abs().max())
    sync()
    fold_err = max(fold_cases.values())
    print(json.dumps({"phase": "compute_kernel_vs_plain", "cases": fold_cases,
                      "card": card}))
    check(fold_err == 0, f"gf_fold disagrees with its plain version:"
          f" {fold_cases}")
    bloom_t0 = time.perf_counter()
    bloom_cases = {}
    for batch in BLOOM_BATCHES:
        h = np.random.default_rng(SEED + batch).integers(
            0, 1 << 32, batch, dtype=np.uint64).astype(np.uint32)
        t_h = torch.from_numpy(h.view(np.int32)).to(dev)
        for nhash in BLOOM_NHASH:
            for nbits in BLOOM_NBITS:
                a = bloom_kernels.bloom_positions(t_h, nbits, nhash)
                b = bloom_kernels.bloom_positions_plain(t_h, nbits, nhash)
                got = a.cpu().numpy().view(np.uint32)
                bloom_cases[f"{batch} {nhash} {nbits}"] = int(
                    (a != b).sum()) + int((got != hitset.bloom_positions(
                        h, nbits, nhash)).sum())
    sync()
    bloom_err = max(bloom_cases.values())
    print(json.dumps({"phase": "bloom_kernel_vs_plain",
                      "cases": len(bloom_cases), "mismatches": sum(
                          bloom_cases.values()),
                      "seconds": time.perf_counter() - bloom_t0,
                      "card": card}))
    seal_t0 = time.perf_counter()
    check(bloom_err == 0, f"bloom_positions disagrees with its plain"
          f" version or numpy: {bloom_cases}")

    def seal_case(sets, nbits, nhash) -> int:
        """Mismatches of the kernel's rows against the plain version's
        and against numpy's scatter-OR of the numpy positions, compared
        word by word where numpy set bits, and by the count of nonzero
        words everywhere else (rows of 2^31 bits stay on the card)."""
        t_h, t_o, most = staged_sets(torch, dev, sets)
        a = bloom_kernels.bloom_seal(t_h, t_o, nbits, nhash, most)
        b = bloom_kernels.bloom_seal_plain(t_h, t_o, nbits, nhash)
        words, values = seal_numpy_words(hitset, sets, nbits, nhash)
        got = a.view(-1)[torch.from_numpy(words).to(dev)].cpu().numpy()
        return (int((a != b).sum()) + int((got != values).sum())
                + abs(int(torch.count_nonzero(a)) - words.size))

    seal_cases = {}
    for batch in BLOOM_BATCHES:
        h = np.random.default_rng(SEED + batch).integers(
            0, 1 << 32, batch, dtype=np.uint64).astype(np.uint32)
        for nhash in BLOOM_NHASH:
            for nbits in BLOOM_NBITS:
                sets = cut_sets(h, nbits, SEED + nhash)
                seal_cases[f"{batch} {nhash} {nbits} in {len(sets)}"] = \
                    seal_case(sets, nbits, nhash)
    tier_nbits, tier_nhash = hitset.bloom_geometry(1024, 0.05)
    rng = np.random.default_rng(SEED + 3)

    def some(n: int):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    many = [some(int(n)) for n in rng.integers(0, 41, SEAL_MAX_SETS)]
    for name, sets, nbits in (
            ("empty set", [some(0)], tier_nbits),
            ("1 hash", [some(1)], tier_nbits),
            ("7 hashes", [some(7)], tier_nbits),
            ("duplicates", [np.repeat(some(5), 13)], tier_nbits),
            ("128 sets", many, tier_nbits),
            ("1100 hashes, 3 blocks a set", [some(1100), some(7)],
             tier_nbits),
            ("past the shared budget", many, SEAL_SHARED_BITS + 1)):
        seal_cases[name] = seal_case(sets, nbits, tier_nhash)
    sync()
    seal_err = max(seal_cases.values())
    print(json.dumps({"phase": "bloom_seal_vs_plain",
                      "cases": len(seal_cases), "mismatches": sum(
                          seal_cases.values()),
                      "seconds": time.perf_counter() - seal_t0,
                      "card": card}))
    check(seal_err == 0, f"bloom_seal disagrees with its plain version or"
          f" numpy: {seal_cases}")

    # -- 2. the main path: writes, the scan, decodes, kernels, models, tier --
    for fn in wrappers.values():
        fn.launches = 0
    objs = scan_objects(CLUSTER_OBJECT)
    cluster = LocalCluster(num_osds=CLUSTER_OSDS,
                           osds_per_host=CLUSTER_OSDS_PER_HOST, device=dev)
    cluster.create_erasure_pool("ecpool", EC_PROFILE)
    io = cluster.open_ioctx("ecpool")
    codec = cluster._codec(io.pool_id)
    check(codec.device == dev and codec.supports_result_decode(),
          "the pool's codec is not on the card or refuses result decodes")
    for name, data in objs.items():
        io.write_full(name, data)

    def gather(name, shards):
        pg = io.object_pg(name)
        acting, _primary = io.acting(pg)
        return [cluster.stores[acting[s]].read(shard_collection(pg, s),
                                               ObjectId(name))
                for s in shards]

    def gather_all():
        return [buf for name in objs for buf in gather(name, range(n))]

    payloads = gather_all()
    check(all(len(p) == stream for p in payloads), "a shard stream is short")
    rsinfo = ec_util.StripeInfo(K, K * lanes)
    maps_order = [(name, lost) for name in objs for lost in SCAN_LOST]

    def result_maps(results):
        maps = []
        for name, lost in maps_order:
            base = list(objs).index(name) * n
            have = [s for s in range(n) if s not in SCAN_LOST[lost]][:K]
            maps.append({s: results[base + s] for s in have})
        return maps

    def combine_all(kern, decoded):
        return [kern.combine([bytes(d)[i * lanes:(i + 1) * lanes]
                              for i in range(K)]) for d in decoded]

    scan = {}
    for kname in ("gf_fold", "gf_fingerprint"):
        kern = compute.get_kernel(kname)
        results = compute.shard_eval_batch(kern, payloads, {}, device=dev)
        gen_before = wrappers["gf_matmul_gen"].launches
        decoded = ec_util.decode_many(rsinfo, codec, result_maps(results))
        scan[kname] = {"results": results,
                       "answers": combine_all(kern, decoded),
                       "gen_launches": wrappers["gf_matmul_gen"].launches
                       - gen_before}
    sync()

    # nonlinear kernels on the objects read back
    back = {name: io.read(name) for name in objs}
    cases = nonlinear_cases()
    nonlinear = [compute.get_kernel(kn).eval_object(back[obj], args,
                                                    device=dev)
                 for kn, obj, args in cases]
    score_launches = wrappers["score_blocks"].launches

    # models stored through the registry into the pool, queried from the
    # OSDs' streams
    chunk = codec.get_chunk_size(K * 4096)
    models = {}
    for kind, dim, out, hidden in MODELS:
        spec, blobs = registry.build(
            f"m-{kind}", kind, registry.make_model(
                kind, dim, out, seed=SEED, hidden=hidden),
            K - MODEL_M, MODEL_M, chunk)
        for oid, blob in blobs.items():
            io.write_full(oid, blob)
        q = np.random.default_rng(SEED + dim).standard_normal(
            (MODEL_QUERIES, dim)).astype(np.float32)
        args = {"model": spec, "q": ikernels.encode_queries(q), "stream": 0}
        streams = gather(spec["params_oid"], range(K))
        contrib = compute.get_kernel("infer_shard").shard_eval(
            streams, args, device=dev)
        models[kind] = {"spec": spec, "q": q, "args": args,
                        "streams": streams, "contrib": contrib,
                        "data": blobs[spec["params_oid"]]}

    # the tier over a Zipf trace, its hit sets hashed on the card
    cfg = {name: options.get_option(name).default for name in TIER_OPTIONS}
    cfg["osd_hit_set_period"] = 0.0     # rotated by call
    trace = zipf_indices(1.1, TIER_OIDS, TIER_READS, seed=SEED)
    pgs = [hitset.hash_oid(f"obj{i}") % TIER_PGS for i in range(TIER_OIDS)]
    sizes = [4096 * (1 + i % 16) for i in range(TIER_OIDS)]
    agent = TierAgent("osd.0", cfg, device=dev)
    t0 = time.perf_counter()
    tier_rot: list = []
    tier_log = drive_tier(agent, trace, pgs, sizes, tier_rot)
    tier_s = time.perf_counter() - t0
    # the query side: the newest sealed set of a few PGs asked for every
    # oid of the trace, one positions_for launch a set (no OSD path asks a
    # set so: this keeps bloom_positions launching beside the path)
    oid_hashes = np.array([hitset.hash_oid(f"obj{i}")
                           for i in range(TIER_OIDS)], dtype=np.uint32)
    query_pgs = sorted(agent.stacks)[:TIER_QUERY_PGS]
    queries = [agent.stacks[pg].archived[-1].contains_batch(
        oid_hashes, device=dev) for pg in query_pgs]
    sync()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    # rotate_all seals PG by PG: one launch a set of DEVICE_MIN_BATCH
    # hashes or more, the smaller ones on the host
    device_seals = sum(
        h.size >= hitset.DEVICE_MIN_BATCH for start in range(
            0, TIER_READS, TIER_ROTATE)
        for h in period_sets(trace, pgs, start))

    # -- 3. checks against the host oracle and the CPU twins ---------------
    cpu_codec = create_erasure_code({**EC_PROFILE, "device": "cpu"})
    scan_ok = {}
    for kname, got in scan.items():
        kern = compute.get_kernel(kname)
        refs = {name: kern.reference(data, {}, k=K, chunk=chunk)
                for name, data in objs.items()}
        twin = compute.shard_eval_batch(kern, payloads, {}, device="cpu")
        twin_answers = combine_all(kern, ec_util.decode_many(
            rsinfo, cpu_codec, result_maps(twin)))
        scan_ok[kname] = {
            "vs_host_reference": all(
                a == refs[name] for a, (name, _l) in zip(got["answers"],
                                                         maps_order)),
            "vs_cpu_twin": [bytes(r) for r in got["results"]]
            == [bytes(r) for r in twin] and got["answers"] == twin_answers,
            "gf_matmul_gen_launches": got["gen_launches"]}
    nonlinear_ok = [got == compute.get_kernel(kn).eval_object(
        back[obj], args, device="cpu")
        for got, (kn, obj, args) in zip(nonlinear, cases)]
    reads_ok = all(back[name] == data for name, data in objs.items())

    infer = {}
    for kind, mdl in models.items():
        spec, q = mdl["spec"], mdl["q"]
        k_model = int(spec["k"])
        parts = [np.frombuffer(c, "<f4").reshape(MODEL_QUERIES, -1)
                 for c in mdl["contrib"]]
        twin = [np.frombuffer(c, "<f4").reshape(MODEL_QUERIES, -1)
                for c in compute.get_kernel("infer_shard").shard_eval(
                    mdl["streams"], mdl["args"], device="cpu")]
        exact = model.exact_forward(spec, mdl["data"], q)
        scores = model.combine_contributions(spec, parts[:k_model])
        rel = float(np.linalg.norm(scores - exact) / np.linalg.norm(exact))
        lost_cases = {}
        for lost in ((0,), (0, 3)):
            def served(ps):
                return fisher.combine(
                    spec, {i: ps[i] for i in range(k_model) if i not in lost},
                    {j: ps[k_model + j] for j in range(MODEL_M)}, q,
                    MODEL_BUDGET)
            res, res_twin = served(parts), served(twin)
            case = {"served": res is not None,
                    "twin_served": res_twin is not None,
                    "structural_error": fisher.structural_error(
                        spec, [i for i in range(k_model) if i not in lost],
                        list(range(MODEL_M)), fisher.query_scale(q))}
            if res is not None:
                case.update(est_error=res[1], rel_error=float(
                    np.linalg.norm(res[0] - exact) / np.linalg.norm(exact)))
            lost_cases[f"lost {list(lost)}"] = case
        infer[kind] = {"exact_rel_error": rel, "lost": lost_cases,
                       "twin_rel_error": float(max(
                           np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                       1e-30)
                           for a, b in zip(parts, twin)))}

    twin_agent = TierAgent("osd.0", cfg, device="cpu")
    t0 = time.perf_counter()
    twin_rot: list = []
    twin_log = drive_tier(twin_agent, trace, pgs, sizes, twin_rot)
    tier_twin_s = time.perf_counter() - t0
    tier_ok = twin_log == tier_log and agent.counters() == \
        twin_agent.counters()
    queries_ok = all(np.array_equal(got, twin_agent.stacks[pg].archived[-1]
                                    .contains_batch(oid_hashes, device="cpu"))
                     for pg, got in zip(query_pgs, queries))
    bloom_ok = {}
    nbits, nhash = hitset.bloom_geometry(cfg["osd_hit_set_target_size"],
                                         cfg["osd_hit_set_bloom_fpp"])
    for batch in (8, 1024, 65536):
        h = np.random.default_rng(batch).integers(
            0, 1 << 32, batch, dtype=np.uint64).astype(np.uint32)
        bloom_ok[batch] = bool(np.array_equal(
            hitset.positions_for(h, nbits, nhash, device=dev),
            hitset.bloom_positions(h, nbits, nhash)))

    result = {"phase": "compute", "objects": SCAN_OBJECTS,
              "object_bytes": CLUSTER_OBJECT, "streams": len(payloads),
              "rows": rows, "lanes": lanes, "scan": scan_ok,
              "reads_exact": reads_ok,
              "nonlinear_vs_cpu_twin": dict(zip(
                  [f"{kn} {obj}" for kn, obj, _a in cases],
                  nonlinear_ok)),
              "nonlinear_results": [r.decode()[:200] for r in nonlinear],
              "score_blocks_launches": score_launches,
              "inference": infer, "inference_rtol": INFER_RTOL,
              "tier": {"reads": TIER_READS, "same_as_cpu_twin": tier_ok,
                       "queries_same_as_cpu_twin": queries_ok,
                       "rotate_all_calls": TIER_READS // TIER_ROTATE,
                       "device_seals": device_seals,
                       "counters": agent.counters(), "seconds": tier_s,
                       "twin_seconds": tier_twin_s},
              "bloom_positions_vs_numpy": bloom_ok,
              "launches": launches, "card": card}
    print(json.dumps(result))
    for kname, ok in scan_ok.items():
        check(ok["vs_host_reference"] and ok["vs_cpu_twin"],
              f"the {kname} scan differs from the host oracle or the twin")
        check(ok["gf_matmul_gen_launches"] > 0,
              f"the {kname} result decode never launched gf_matmul_gen")
    check(reads_ok, "an object read back differs from the written one")
    check(all(nonlinear_ok), "a nonlinear kernel differs from its CPU twin")
    check(score_launches > 0, "compress_score never launched score_blocks")
    for kind, res in infer.items():
        check(res["exact_rel_error"] <= INFER_RTOL,
              f"{kind}: exact combine off by {res['exact_rel_error']}")
        check(res["twin_rel_error"] <= INFER_RTOL,
              f"{kind}: contributions differ from the CPU twin")
        for lost, case in res["lost"].items():
            check(case["served"] == case["twin_served"],
                  f"{kind} {lost}: the budget gate decided otherwise on the"
                  " CPU twin")
            check(case["served"] or case["structural_error"] > MODEL_BUDGET,
                  f"{kind} {lost}: refused within the budget")
            if case["served"]:
                check(case["est_error"] <= MODEL_BUDGET
                      and case["rel_error"] <= max(case["est_error"], 1e-6),
                      f"{kind} {lost}: served outside the budget: {case}")
    check(infer["linear"]["lost"]["lost [0]"]["served"]
          and infer["linear"]["lost"]["lost [0, 3]"]["served"],
          "the linear scorer was not served with data streams lost")
    check(tier_ok, "the tier agent on the card decided otherwise than its"
          " CPU twin")
    check(queries_ok, "a sealed set on the card answered a query"
          " otherwise than its CPU twin")
    check(all(bloom_ok.values()), f"bloom positions on the card: {bloom_ok}")
    for name in ("gf_fold", "gf_matmul_spec", "gf_matmul_gen",
                 "score_blocks", "bloom_positions", "bloom_seal"):
        check(launches[name] > 0, f"{name} never launched on the compute"
              f" path: {launches}")
    check(launches["bloom_seal"] == device_seals
          and launches["bloom_positions"] == len(query_pgs),
          f"the tier's hit sets took {launches['bloom_seal']} seals for"
          f" {device_seals} sets of {hitset.DEVICE_MIN_BATCH} hashes or more"
          f" and {launches['bloom_positions']} position launches for"
          f" {len(query_pgs)} queries")

    # -- 4. times ------------------------------------------------------------
    kern = compute.get_kernel("gf_fingerprint")

    def stage():
        st = torch.empty(wave.shape, dtype=torch.uint8, pin_memory=True)
        host = st.numpy()
        for i, p in enumerate(payloads):
            host[i] = np.frombuffer(p, np.uint8).reshape(rows, lanes)
        return st.to(dev, non_blocking=True)

    staged = stage()
    maps = result_maps(scan["gf_fingerprint"]["results"])
    decoded = ec_util.decode_many(rsinfo, codec, maps)
    steps = {
        "gather_s": host_median_s(torch, gather_all),
        "stage_s": host_median_s(torch, stage),
        "fold_s": host_median_s(torch, lambda: plan.compute_eval(
            kern.name, kern.row_weights(rows), staged, dev)),
        "shard_eval_batch_s": host_median_s(
            torch, lambda: compute.shard_eval_batch(kern, payloads, {},
                                                    device=dev)),
        "decode_s": host_median_s(
            torch, lambda: ec_util.decode_many(rsinfo, codec, maps)),
        "combine_s": host_median_s(torch, lambda: combine_all(kern,
                                                              decoded))}
    total = (steps["gather_s"] + steps["shard_eval_batch_s"]
             + steps["decode_s"] + steps["combine_s"])
    shard_gib = len(payloads) * stream / (1 << 30)
    steps["scan_gib_per_s"] = shard_gib / total
    qps = {}
    for kind, mdl in models.items():
        shard_kernel = compute.get_kernel("infer_shard")
        qps[kind] = MODEL_QUERIES / host_median_s(
            torch, lambda: model.combine_contributions(mdl["spec"], [
                np.frombuffer(c, "<f4").reshape(MODEL_QUERIES, -1)
                for c in shard_kernel.shard_eval(
                    mdl["streams"], mdl["args"], device=dev)][
                        :int(mdl["spec"]["k"])]))
    fold_times = {}
    for kind in ("gf_fold", "gf_fingerprint"):
        w = weights_of(kind, rows)
        out = torch.empty((wave.shape[0], 1, lanes), dtype=torch.uint8,
                          device=dev)
        n_bytes = wave.numel() + out.numel() + (0 if w is None else rows)
        b_ms, by = bound(n_bytes, 0)
        t = {"ms": alone_ms(lambda: fold_kernels.gf_fold(w, wave, out=out)),
             "back_to_back_ms": back_to_back_ms(
                 lambda: fold_kernels.gf_fold(w, wave, out=out)),
             "kernel_ms": kernel_ms(
                 lambda: fold_kernels.gf_fold(w, wave, out=out),
                 "gf_fold_kernel"),
             "host_us": host_us(
                 lambda: fold_kernels.gf_fold(w, wave, out=out)),
             "plain_ms": alone_ms(lambda: fold_kernels.gf_fold_plain(
                 w, wave), reps=5, warmup=1),
             "bound_ms": b_ms, "bound_by": by}
        t["share_alone"] = b_ms / t["ms"]
        t["share_back_to_back"] = b_ms / t["back_to_back_ms"]
        fold_times[kind] = t
    hashes = {}
    for batch in (1024, 65536):
        h = np.random.default_rng(batch).integers(
            0, 1 << 32, batch, dtype=np.uint64).astype(np.uint32)
        # CUDA work per positions_for call: one copy in, the bloom kernel,
        # one copy out
        per_call = profile_calls(torch, lambda: hitset.positions_for(
            h, nbits, nhash, device=dev), "bloom_positions_kernel")
        profile_ok = len(per_call) >= 3 and all(
            c == ["copy", "kernel", "copy"] for c in per_call)
        t_dev = torch.from_numpy(h.astype(np.int64)).to(dev)
        t_32 = torch.from_numpy(h.view(np.int32)).to(dev)
        out_32 = torch.empty((batch, nhash), dtype=torch.int32, device=dev)

        def launch():
            bloom_kernels.bloom_positions(t_32, nbits, nhash, out=out_32)

        hashes[batch] = {
            "positions_for_ms": host_median_s(
                torch, lambda: hitset.positions_for(h, nbits, nhash,
                                                    device=dev),
                reps=20) * 1e3,
            "ms": alone_ms(launch),
            "kernel_ms": kernel_ms(launch, "bloom_positions_kernel"),
            "plain_on_device_ms": alone_ms(
                lambda: hitset.bloom_positions_torch(t_dev, nbits, nhash)),
            "host_numpy_ms": host_median_s(
                torch, lambda: hitset.bloom_positions(h, nbits, nhash),
                reps=20) * 1e3,
            "cuda_work_per_call": per_call[:2]}
        check(profile_ok, f"positions_for at {batch} hashes: the CUDA"
              f" work of its calls was {per_call}, not one copy in, the"
              f" bloom kernel and one copy out")
    # one PG's seal as rotate_all makes it (the last period's median set):
    # insert_batch, one copy in, the seal kernel, one copy out
    period = sorted(period_sets(trace, pgs, TIER_READS - TIER_ROTATE),
                    key=len)
    pg_set = period[len(period) // 2]
    per_call = profile_calls(torch, lambda: hitset.BloomHitSet(
        nbits=nbits, nhash=nhash).insert_batch(pg_set, device=dev),
        "bloom_seal_kernel")
    check(len(per_call) >= 3 and all(c == ["copy", "kernel", "copy"]
                                     for c in per_call),
          f"a PG's seal's CUDA work was {per_call}, not one copy in, the"
          " seal kernel and one copy out")
    w_h, w_o, w_most = staged_sets(torch, dev, [pg_set])
    w_out = torch.empty((1, bloom_kernels.seal_words(nbits)),
                        dtype=torch.int32, device=dev)

    def seal_launch():
        bloom_kernels.bloom_seal(w_h, w_o, nbits, nhash, w_most, out=w_out)

    b_ms, by = bound(4 * pg_set.size + 8 + w_out.numel() * 4,
                     pg_set.size * nhash * SEAL_OPS_PER_POSITION)
    seal_row = {
        "hashes": int(pg_set.size),
        "ms": alone_ms(seal_launch),
        "kernel_ms": kernel_ms(seal_launch, "bloom_seal_kernel"),
        "queued_ms": queued_ms(seal_launch),
        "host_us": host_us(seal_launch),
        "insert_batch_ms": host_median_s(torch, lambda: hitset.BloomHitSet(
            nbits=nbits, nhash=nhash).insert_batch(pg_set, device=dev),
            reps=20) * 1e3,
        "plain_ms": alone_ms(lambda: bloom_kernels.bloom_seal_plain(
            w_h, w_o, nbits, nhash), reps=5, warmup=1),
        "bound_ms": b_ms, "bound_by": by, "max_abs_err": seal_err,
        "cuda_work_per_call": per_call[:2]}
    # what phase 3k holds its OSD scan and queries against
    PHASE_RESULTS["compute"] = {
        "answers": {kname: {name: ans for (name, lost), ans
                            in zip(maps_order, got["answers"])
                            if lost == "data"}
                    for kname, got in scan.items()},
        "nonlinear": nonlinear, "scan_gib_per_s": steps["scan_gib_per_s"],
        "inference_qps": qps}
    print(json.dumps({"phase": "compute_times", "scan_steps": steps,
                      "shard_gib": shard_gib, "inference_qps": qps,
                      "gf_fold": fold_times,
                      "bloom": {"nbits": nbits, "nhash": nhash,
                                "by_batch": hashes, "seal_one_pg": seal_row},
                      "tier_reads_per_s": TIER_READS / tier_s,
                      "tier_twin_reads_per_s": TIER_READS / tier_twin_s,
                      "tier_rate_vs_twin": tier_twin_s / tier_s,
                      "tier_rotate_all_s": sum(tier_rot),
                      "tier_twin_rotate_all_s": sum(twin_rot),
                      "seconds_in_phase": time.perf_counter() - phase_t0,
                      "card": card}))
    # the kernels-line row: the tier's geometry at 65,536 hashes
    big = BLOOM_BATCHES[3]
    h = np.random.default_rng(big).integers(
        0, 1 << 32, big, dtype=np.uint64).astype(np.uint32)
    t_32 = torch.from_numpy(h.view(np.int32)).to(dev)
    out_32 = torch.empty((big, nhash), dtype=torch.int32, device=dev)
    b_ms, by = bound(4 * big + 4 * big * nhash,
                     big * nhash * BLOOM_OPS_PER_POSITION)
    def launch_big():
        bloom_kernels.bloom_positions(t_32, nbits, nhash, out=out_32)

    bloom_row = {
        "ms": alone_ms(launch_big),
        "kernel_ms": kernel_ms(launch_big, "bloom_positions_kernel"),
        "queued_ms": queued_ms(launch_big),
        "plain_ms": alone_ms(lambda: bloom_kernels.bloom_positions_plain(
            t_32, nbits, nhash), reps=5, warmup=1),
        "bound_ms": b_ms, "bound_by": by, "max_abs_err": bloom_err}
    return {"launches": launches, "fold_err": fold_err,
            "fold_times": fold_times, "bloom": bloom_row, "seal": seal_row}


# phase 3h: the monitors.  Three port mons as processes on the 10,000-OSD
# cluster of phase 3c (build_simple, 10 OSDs a host), signed and sealed,
# compressing.  The pools are far smaller than phase 3c's: the mon's
# `health` maps every PG on the host inside the leader's event loop (the
# reference's design, about 2.5 ms a replicated PG at 10,000 OSDs), and a
# leader that holds its loop past the lease's slack (mon_lease 2 s, renewed
# every 0.8 s) is voted out; 128 + 32 PGs keep a walk near half a second.
# The out and down shares are phase 3c's over ten: each commit re-encodes
# and persists the whole 650 KB map on every mon, about 55 ms (3c's 700
# OSDs would be 40 s of commits).
MON_OSDS, MON_OSDS_PER_HOST = 10000, 10
MON_REP_PGS, MON_EC_PGS = 128, 32
MON_OUT_SHARE, MON_DOWN_SHARE = OUT_SHARE / 10, DOWN_SHARE / 10
MON_RTT_CALLS = 200         # mon stat round trips per timed run
MON_LATENCY_COMMITS = 3     # out commits timed to the subscriber's map
MON_DRIVE_TIMEOUT = 240.0


class MonClient:
    """A bare port Messenger that sends mon commands (retrying through an
    election or a dead mon) and follows the published maps: full maps and
    incrementals applied in epoch order to one port OSDMap."""

    def __init__(self, mon_addrs, secret, secure, compress=""):
        from ceph_tpu_torch.msg import Messenger
        from ceph_tpu_torch.msg import messages as mm

        self.mm = mm
        self.msgr = Messenger("client.chip_smoke", secret=secret)
        self.msgr.secure = secure
        if compress:
            self.msgr.apply_compress_config({"ms_compress_methods": compress})
        self.msgr.dispatcher = self._dispatch
        self.addrs = list(mon_addrs)
        self.target = 0
        self.tid = 0
        self.futures = {}
        self.osdmap = None
        self.epoch_seen = {}        # epoch -> host clock of its arrival

    async def _dispatch(self, conn, msg) -> None:
        import asyncio

        from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap

        mm = self.mm
        if isinstance(msg, mm.MMonCommandReply):
            fut = self.futures.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, mm.MOSDMapMsg):
            if msg.full_map and (self.osdmap is None
                                 or msg.epoch > self.osdmap.epoch):
                self.osdmap = OSDMap.decode(msg.full_map)
            for raw in msg.incrementals:
                inc = Incremental.decode(raw)
                if self.osdmap is not None and \
                        inc.epoch == self.osdmap.epoch + 1:
                    self.osdmap.apply_incremental(inc)
            if self.osdmap is not None:
                self.epoch_seen.setdefault(self.osdmap.epoch,
                                           time.perf_counter())
            await asyncio.sleep(0)

    async def command(self, cmd: dict, timeout: float = 10.0,
                      deadline_s: float = 30.0):
        import asyncio

        t_end = time.perf_counter() + deadline_s
        last = None
        while time.perf_counter() < t_end:
            self.tid += 1
            tid = self.tid
            fut = asyncio.get_running_loop().create_future()
            self.futures[tid] = fut
            try:
                conn = await self.msgr.connect(self.addrs[self.target])
                await conn.send(self.mm.MMonCommand(tid, cmd))
                reply = await asyncio.wait_for(fut, timeout)
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                last = repr(e)
                self.target = (self.target + 1) % len(self.addrs)
                await asyncio.sleep(0.05)
                continue
            finally:
                self.futures.pop(tid, None)
            if reply.rc == -11:
                last = reply.out
                await asyncio.sleep(0.05)
                continue
            return reply.rc, reply.out
        fail(f"mon command {cmd.get('prefix')} got no answer: {last}")

    async def ok(self, cmd: dict):
        rc, out = await self.command(cmd)
        check(rc == 0, f"mon command {cmd} returned {rc}: {out}")
        return out

    async def subscribe(self, addr: str) -> None:
        since = self.osdmap.epoch if self.osdmap is not None else 0
        conn = await self.msgr.connect(addr)
        await conn.send(self.mm.MGetMap(since_epoch=since, subscribe=True))

    async def wait_epoch(self, epoch: int, timeout: float = 20.0) -> None:
        import asyncio

        t_end = time.perf_counter() + timeout
        while self.osdmap is None or self.osdmap.epoch < epoch:
            if time.perf_counter() > t_end:
                fail(f"the subscriber never reached epoch {epoch}")
            await asyncio.sleep(0.002)


def _free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


def mon_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3h: three `python -m ceph_tpu_torch.mon` processes (and a
    fourth, standalone and signed only, for the signed round trips), driven
    by a client Messenger through quorum, an EC profile, two pools, OSDs
    out and down, an upmap, health, a kill -9 of the leader, a commit
    through the new leader and the killed rank's restart from its store; the
    subscriber's maps at three epochs mapped by OSDMapMapping on the card,
    against its CPU twin and the host path; every store's final map against
    the subscriber's.  Returns the launches and the numbers."""
    import asyncio
    import os
    import shutil
    import tempfile

    from ceph_tpu_torch.common import auth
    from ceph_tpu_torch.kv import SQLiteDB
    from ceph_tpu_torch.msg import messages as mm
    from ceph_tpu_torch.osd.osdmap import OSDMap, OSDMapMapping, PgId

    phase_t0 = time.perf_counter()
    aead = auth._resolve_aead()
    check(aead == "native", f"secure frames would not run the native"
          f" AES-GCM here: _resolve_aead() is {aead!r}")
    secret = auth.generate_secret()
    config = {"auth_secret": secret, "auth_secure": True,
              "ms_local_fastpath": False,
              "ms_compress_methods": "snappy,zlib"}
    signed_config = {"auth_secret": secret, "ms_local_fastpath": False}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mon_")
    ports = _free_ports(4)
    addrs = [f"127.0.0.1:{p}" for p in ports[:3]]
    stores = [os.path.join(tmp, f"mon.{r}") for r in range(3)]

    # every mon's store starts with the cluster's first map, all 10,000
    # OSDs up and in (the `ceph-mon --mkfs --osdmap` role: booting 10,000
    # OSDs through MOSDBoot would be 10,000 commits); the mons load it
    seed_map = OSDMap.build_simple(MON_OSDS, osds_per_host=MON_OSDS_PER_HOST)
    for path in stores:
        db = SQLiteDB(path)
        db.create_and_open()
        t = db.get_transaction()
        t.set("mon", b"osdmap_full", seed_map.encode())
        db.submit_transaction_sync(t)
        db.close()

    def spawn(rank: int, standalone: bool = False):
        argv = [sys.executable, "-m", "ceph_tpu_torch.mon", "--num-osds",
                str(MON_OSDS), "--osds-per-host", str(MON_OSDS_PER_HOST)]
        if standalone:
            argv += ["--port", str(ports[3]), "--config",
                     json.dumps(signed_config)]
        else:
            argv += ["--rank", str(rank), "--mon-addrs", ",".join(addrs),
                     "--store-path", stores[rank], "--config",
                     json.dumps(config)]
        log = open(os.path.join(tmp, f"mon.{'s' if standalone else rank}"
                                     ".log"), "a")
        return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=log,
                                text=True)

    async def read_addr(proc) -> str:
        line = await asyncio.to_thread(proc.stdout.readline)
        check(line.startswith("MON_ADDR"), f"a mon process printed"
              f" {line!r} (exit {proc.poll()})")
        return line.split()[1]

    procs = {}
    timings, out = {}, {}

    async def stat(client):
        return await client.ok({"prefix": "mon stat"})

    async def rtt_rate(client) -> float:
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(MON_RTT_CALLS):
                await client.ok({"prefix": "mon stat"})
            rates.append(MON_RTT_CALLS / (time.perf_counter() - t0))
        return statistics.median(rates)

    async def drive():
        t_spawn = time.perf_counter()
        for r in range(3):
            procs[r] = spawn(r)
        procs["signed"] = spawn(0, standalone=True)
        for proc in procs.values():
            await read_addr(proc)
        timings["processes_bound_s"] = time.perf_counter() - t_spawn
        client = MonClient(addrs, secret, secure=True, compress="snappy,zlib")
        while True:
            st = await stat(client)
            if len(st.get("quorum", [])) >= 2 and st.get("lease_valid"):
                break
            check(time.perf_counter() - t_spawn < 60, f"no quorum: {st}")
            await asyncio.sleep(0.02)
        timings["time_to_quorum_s"] = time.perf_counter() - t_spawn
        leader = st["leader"]
        client.target = leader
        await client.subscribe(addrs[leader])
        await client.wait_epoch(1)
        maps = {}

        async def settle(name: str) -> None:
            epoch = (await client.ok({"prefix": "status"}))["epoch"]
            await client.wait_epoch(epoch)
            maps[name] = client.osdmap.encode()

        # the pools of phase 3c's shapes, at the mon path's PG counts
        await client.ok({"prefix": "osd erasure-code-profile set",
                         "name": "ec83", "profile": dict(EC_PROFILE)})
        rep_id = (await client.ok({
            "prefix": "osd pool create", "name": "rbd", "size": 3,
            "pg_num": MON_REP_PGS, "pool_type": "replicated"}))["pool_id"]
        ec_id = (await client.ok({
            "prefix": "osd pool create", "name": "ec83",
            "pg_num": MON_EC_PGS, "pool_type": "erasure",
            "erasure_code_profile": "ec83"}))["pool_id"]
        await settle("after pool creates")

        # OSDs out and down by seeded draw; the last outs timed from the
        # command to the subscriber's map
        order = [int(o) for o in np.random.default_rng(SEED + 8)
                 .permutation(MON_OSDS)]
        n_out = int(MON_OSDS * MON_OUT_SHARE)
        n_down = int(MON_OSDS * MON_DOWN_SHARE)
        t0 = time.perf_counter()
        for osd in order[MON_LATENCY_COMMITS:n_out]:
            await client.ok({"prefix": "osd out", "osd": osd})
        for osd in order[n_out:n_out + n_down]:
            await client.ok({"prefix": "osd down", "osd": osd})
        timings["out_down_commits"] = n_out + n_down - MON_LATENCY_COMMITS
        timings["seconds_per_commit"] = (time.perf_counter() - t0) / (
            n_out + n_down - MON_LATENCY_COMMITS)
        # the first outs one at a time, the subscriber caught up before
        # each: command to the leader's reply (the commit) and command to
        # the subscriber's map of that epoch
        replies, arrivals = [], []
        for osd in order[:MON_LATENCY_COMMITS]:
            epoch = (await client.ok({"prefix": "status"}))["epoch"]
            await client.wait_epoch(epoch)
            t_cmd = time.perf_counter()
            await client.ok({"prefix": "osd out", "osd": osd})
            replies.append(time.perf_counter() - t_cmd)
            await client.wait_epoch(epoch + 1)
            arrivals.append(client.epoch_seen[epoch + 1] - t_cmd)
        timings["command_to_commit_reply_s"] = statistics.median(replies)
        timings["command_to_subscriber_map_s"] = statistics.median(arrivals)
        await settle("after out and down")

        # one upmap, then health, status and mon stat
        m = client.osdmap
        pg = PgId(rep_id, 0)
        raw, _pps = m._pg_to_raw_osds(m.pools[rep_id], pg)
        dst = next(o for o in order[n_out + n_down:] if o not in raw)
        await client.ok({"prefix": "osd pg-upmap-items", "pgid": f"{pg}",
                         "mappings": [[raw[0], dst]]})
        # the first health walks every PG on the leader's host mapper; the
        # leader's placement cache serves the same epoch's later calls
        for prefix in ("health", "status", "mon stat"):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                res = await client.ok({"prefix": prefix})
                runs.append(time.perf_counter() - t0)
            out[prefix] = res
            key = prefix.replace(" ", "_")
            timings[key + "_first_s"] = runs[0]
            timings[key + "_s"] = statistics.median(runs)

        # mon stat round trips: secure frames to the quorum's leader,
        # signed frames to the standalone mon
        timings["mon_stat_per_s_secure"] = await rtt_rate(client)
        signed = MonClient([f"127.0.0.1:{ports[3]}"], secret, secure=False)
        timings["mon_stat_per_s_signed"] = await rtt_rate(signed)
        await signed.msgr.shutdown()

        # kill -9 the leader; the survivors elect; one more commit through
        # the new leader
        t0 = time.perf_counter()
        procs[leader].kill()
        await asyncio.to_thread(procs[leader].wait)
        client.target = (leader + 1) % 3
        while True:
            rc, st = await client.command({"prefix": "mon stat"},
                                          timeout=0.5)
            if rc == 0 and st.get("leader") not in (None, leader) and \
                    st.get("lease_valid"):
                break
            check(time.perf_counter() - t0 < 60, f"no new leader: {st}")
            await asyncio.sleep(0.02)
        timings["reelection_s"] = time.perf_counter() - t0
        out["new_leader"] = st["leader"]
        client.target = st["leader"]
        await client.subscribe(addrs[st["leader"]])
        await client.ok({"prefix": "osd in", "osd": order[0]})
        await settle("final")
        final_epoch = client.osdmap.epoch

        # the killed rank restarts from its store and catches up
        t0 = time.perf_counter()
        procs[leader] = spawn(leader)
        await read_addr(procs[leader])
        probe = MonClient([addrs[leader]], secret, secure=True)
        conn = await probe.msgr.connect(addrs[leader])
        while probe.osdmap is None or probe.osdmap.epoch < final_epoch:
            await conn.send(mm.MGetMap(since_epoch=0))
            await asyncio.sleep(0.05)
            check(time.perf_counter() - t0 < 60,
                  "the restarted mon never caught up")
        timings["restart_catch_up_s"] = time.perf_counter() - t0
        out["restarted_rank_epoch"] = probe.osdmap.epoch
        out["restarted_rank_map_equal"] = \
            probe.osdmap.encode() == client.osdmap.encode()
        await probe.msgr.shutdown()
        # it calls an election on boot; with a lower election epoch than
        # the survivors' promises it bids until it passes them
        while True:
            st = await stat(client)
            if len(st.get("quorum", [])) == 3 and st.get("lease_valid"):
                break
            check(time.perf_counter() - t0 < 60, f"the restarted mon never"
                  f" rejoined the quorum: {st}")
            await asyncio.sleep(0.05)
        timings["restart_to_full_quorum_s"] = time.perf_counter() - t0
        out["mon_stat_after_restart"] = st
        await client.msgr.shutdown()
        return maps, final_epoch, {"rep": rep_id, "ec": ec_id, "out": n_out,
                                   "down": n_down}

    for fn in wrappers.values():
        fn.launches = 0
    try:
        maps, final_epoch, info = asyncio.run(
            asyncio.wait_for(drive(), MON_DRIVE_TIMEOUT))
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    drive_s = time.perf_counter() - phase_t0

    # every store's final map, read after the kill, against the
    # subscriber's
    stored = []
    for path in stores:
        db = SQLiteDB(path)
        db.create_and_open()
        stored.append(db.get("mon", b"osdmap_full"))
        db.close()
    shutil.rmtree(tmp, ignore_errors=True)
    stores_equal = [raw == maps["final"] for raw in stored]

    # map on the card at each epoch, against the CPU twin and the host path
    rng = np.random.default_rng(SEED + 9)
    mapping = {}
    for name, raw in maps.items():
        m = OSDMap.decode(raw)
        t0 = time.perf_counter()
        got = OSDMapMapping(m, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        twin = OSDMapMapping(m, device="cpu")
        twin_s = time.perf_counter() - t0
        pgs = [PgId(p.id, ps) for p in m.pools.values()
               for ps in range(p.pg_num)]
        twin_bad = sum(got.get(pg) != twin.get(pg) for pg in pgs)
        host_bad = host_n = 0
        for pool in m.pools.values():
            for ps in rng.choice(pool.pg_num, min(pool.pg_num,
                                                  OSDMAP_SAMPLES),
                                 replace=False):
                pg = PgId(pool.id, int(ps))
                host_bad += got.get(pg) != m.pg_to_up_acting_osds(pg)
                host_n += 1
        mapping[name] = {"epoch": m.epoch, "pgs": len(pgs),
                         "mapping_s": card_s, "twin_s": twin_s,
                         "twin_mismatches": int(twin_bad),
                         "host_path_pgs": host_n,
                         "host_path_mismatches": int(host_bad),
                         "up_osds": len(m.get_up_osds()),
                         "in_osds": sum(map(m.is_in, range(m.max_osd)))}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}

    health = out["health"]
    status = out["status"]
    result = {"phase": "mon", "osds": MON_OSDS, "pools": info,
              "aead": aead, "timings": timings, "mapping": mapping,
              "health": {"status": health["status"], "checks": {
                  k: v["summary"] for k, v in health["checks"].items()}},
              "status_epoch": status["epoch"], "final_epoch": final_epoch,
              "new_leader": out["new_leader"],
              "restarted_rank_epoch": out["restarted_rank_epoch"],
              "restarted_rank_map_equal": out["restarted_rank_map_equal"],
              "quorum_after_restart": out["mon_stat_after_restart"].get(
                  "quorum"),
              "stores_equal_subscriber": stores_equal,
              "drive_s": drive_s,
              "seconds": time.perf_counter() - phase_t0,
              "launches": launches, "card": card}
    print(json.dumps(result))
    check(all(stores_equal), "a mon's stored map differs from the"
          " subscriber's final map")
    check(out["restarted_rank_epoch"] == final_epoch
          and out["restarted_rank_map_equal"],
          "the restarted mon did not catch up to the final map")
    check(status["num_in_osds"] == MON_OSDS - info["out"]
          and status["num_up_osds"] == MON_OSDS - info["down"],
          f"status counts differ from the commands: {status}")
    check(health["checks"].get("OSD_DOWN", {}).get("summary")
          == f"{info['down']} osds down", f"health: {health}")
    for name, res in mapping.items():
        check(res["twin_mismatches"] == 0 and res["host_path_mismatches"]
              == 0, f"the card's mapping at {name} differs: {res}")
    check(launches["crush_do_rule_batch"] > 0,
          "the subscriber's mappings never launched the placement kernel")
    return {"launches": launches, "timings": timings}


# phase 3i: BASELINE config 5 below RGW through the OSD daemons, in the
# shape bench.py gives it: one mon and 12 OSDs, 3 to a host, in one asyncio
# loop; pool rgw.data EC 8+3 with 64 KiB stripe units over OSDs, pool
# rgw.meta replicated size 3; a 64 MiB PUT as 16 RADOS objects of 4 MiB
# (rgw_obj_stripe_size), four 16 MiB parts in flight together
OSD_OSDS, OSD_OSDS_PER_HOST = 12, 3
OSD_PROFILE = {"plugin": "ec_torch", "technique": "reed_sol_van",
               "k": str(K), "m": str(M), "crush-failure-domain": "osd",
               "stripe_unit": "65536"}
OSD_PUT, OSD_PART, OSD_OBJECT = 64 << 20, 16 << 20, 4 << 20
OSD_TRIALS = 2              # the first warms; two, for the time limit
OSD_META_OBJECTS = 8
OSD_CONFIG = {"osd_heartbeat_interval": 3.0, "osd_heartbeat_grace": 20.0}
OSD_MON_CONFIG = {"mon_osd_min_down_reporters": 1}
OSD_PHASE_TIMEOUT = 300.0
PHASE_RESULTS: dict = {}    # what a later phase compares with

# phase 3j: recovery on phase 3i's cluster.  Revive 3i's three victims; drain
# one OSD holding data shards (kill, down, out), write one more 64 MiB PUT
# while it is out; refill it (revive, in); then phase 3e's MSR 4/3/6 profile
# over OSDs in a pool of 8 objects of 4 MiB, and one more OSD lost and out.
RECOVERY_MSR_PROFILE = {"plugin": "ec_msr", "k": "4", "m": "3", "d": "6",
                        "crush-failure-domain": "osd"}
RECOVERY_MSR_OBJECTS = 8
RECOVERY_MSR_SLACK = 0.1    # over d / alpha, bytes read per byte rebuilt

# phase 3k: on the same cluster, rgw.data grows from 8 to 32 PGs with every
# object at rest (then one more 4 MiB object goes into a child PG); phase
# 3g's four 64 MiB scan objects go into rgw.data and its two models into
# rgw.models, and the OSDs scan and serve them healthy, with one and with
# three data shards' OSDs down (marked down, not out: the PGs serve degraded)
SPLIT_PG_NUM = 32
OSD_SCAN_OBJECT = CLUSTER_OBJECT
OSD_MODELS = MODELS
OSD_SCAN_REPEATS = 3        # healthy gf_fold scans timed on the card
LINEAR_KERNELS = ("gf_fold", "gf_fingerprint")
EAGAIN_RC = -11
# the models' pool (made in 3j, beside msr.data): rgw.data's EC 8+3 at the
# default stripe unit, where the client's 4096-byte model layout matches the
# OSDs' (on rgw.data every query would take the exact path: ROADMAP C8); two
# PGs hold the two models
MODEL_POOL = "rgw.models"
MODEL_POOL_PROFILE = {k: v for k, v in OSD_PROFILE.items()
                      if k != "stripe_unit"}
MODEL_POOL_PGS = 2


async def osd_cluster_start(device):
    """Phase 3i's cluster (config 5's shape): one mon and 12 MemStore OSDs
    on `device`, 3 to a host, in this loop; rgw.meta replicated size 3 and
    rgw.data EC 8+3 at 64 KiB units, 8 PGs each; a RADOS client."""
    from ceph_tpu_torch.mon import MonDaemon
    from ceph_tpu_torch.os.memstore import MemStore
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.rados.client import RadosClient

    mon = MonDaemon(OSD_OSDS, osds_per_host=OSD_OSDS_PER_HOST,
                    config=dict(OSD_MON_CONFIG))
    addr = await mon.start()
    osds, stores = {}, {}
    for i in range(OSD_OSDS):
        store = MemStore()
        store.mkfs()
        store.mount()
        stores[i] = store
        osds[i] = OSDDaemon(i, [addr], store=store,
                            config=dict(OSD_CONFIG), device=device)
        await osds[i].start()
    client = RadosClient([addr])
    await client.connect()
    await client.create_replicated_pool("rgw.meta", size=3, pg_num=8)
    await client.create_ec_pool("rgw.data", dict(OSD_PROFILE), pg_num=8)
    return mon, osds, stores, client


async def osd_cluster_stop(mon, osds, client):
    await client.shutdown()
    for osd in osds.values():
        await osd.stop()
    await mon.shutdown()


async def pool_active(mon, osds, pool_id):
    """Every PG of the pool active on its live primary."""
    import asyncio

    from ceph_tpu_torch.osd.osdmap import PgId

    for _ in range(600):
        ok = True
        for ps in range(mon.osdmap.pools[pool_id].pg_num):
            pg = PgId(pool_id, ps)
            _a, primary = mon.osdmap.pg_to_acting_osds(pg)
            st = osds[primary].pgs.get(pg) if primary in osds else None
            ok = ok and st is not None and st.state == "active" and \
                osds[primary].osdmap.epoch >= mon.osdmap.epoch
        if ok:
            return
        await asyncio.sleep(0.05)
    fail(f"pool {pool_id} never went active")


async def wait_clean(mon, osds, timeout: float = OSD_PHASE_TIMEOUT) -> float:
    """Every PG of every pool active and found on its live primary, every
    live OSD at the mon's epoch; returns the seconds it took."""
    import asyncio

    from ceph_tpu_torch.osd.osdmap import PgId

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        epoch = mon.osdmap.epoch
        ok = all(o.osdmap is not None and o.osdmap.epoch >= epoch
                 for o in osds.values())
        for pool in mon.osdmap.pools.values():
            for ps in range(pool.pg_num if ok else 0):
                pg = PgId(pool.id, ps)
                _a, primary = mon.osdmap.pg_to_acting_osds(pg)
                st = osds[primary].pgs.get(pg) if primary in osds else None
                ok = ok and st is not None and st.state == "active" \
                    and not st.unfound
        if ok:
            return time.perf_counter() - t0
        await asyncio.sleep(0.05)
    fail("the cluster never went clean")


def data_shard_victims(osdmap, io, names, n: int) -> list:
    """`n` OSDs holding data shards of the objects `names`: primaries of
    none of them first, then the most data shards."""
    acting = [osdmap.pg_to_acting_osds(io.object_pg(o)) for o in names]
    primaries = {p for _a, p in acting}
    holders: dict = {}
    for a, _p in acting:
        for osd in a[:K]:
            holders[osd] = holders.get(osd, 0) + 1
    return sorted(holders, key=lambda o: (o in primaries, -holders[o],
                                          o))[:n]


def pg_logs(mon, stores, pool_id):
    """Each PG's log entries (oid, op, version) in order, from its
    primary's store: the order the concurrent writes took."""
    from ceph_tpu_torch.os import ObjectId
    from ceph_tpu_torch.osd.osdmap import TYPE_ERASURE, PgId
    from ceph_tpu_torch.osd.pg_log import PGMETA_OID
    from ceph_tpu_torch.rados.embedded import shard_collection

    pool = mon.osdmap.pools[pool_id]
    out = {}
    for ps in range(pool.pg_num):
        pg = PgId(pool_id, ps)
        acting, primary = mon.osdmap.pg_to_acting_osds(pg)
        shard = acting.index(primary) if pool.type == TYPE_ERASURE else -1
        omap = stores[primary].omap_get(shard_collection(pg, shard),
                                        ObjectId(PGMETA_OID))
        out[ps] = [(e["oid"], e["op"], e["version"])
                   for e in json.loads(omap["log"])]
    return out


def snapshot(stores, pool_id, omap: bool = False):
    """Every shard object's bytes and xattrs (and, with `omap`, its omap),
    per OSD (the pg-meta omap holds hit sets sealed on the clock, so it is
    left out)."""
    out = {}
    for osd_id, store in stores.items():
        for cid in store.list_collections():
            if not cid.startswith(f"{pool_id}."):
                continue
            for oid in store.list_objects(cid):
                if oid.name.startswith("_"):
                    continue
                out[(osd_id, cid, oid.name)] = (
                    store.read(cid, oid), store.getattrs(cid, oid)) + (
                    (store.omap_get(cid, oid),) if omap else ())
    return out


def service_counts(osd):
    """An OSD's encode-service counters, with its requests and batches by
    bucket kind (encode_hinfo, encode, decode)."""
    out = dict(osd.encode_service.counters)
    for label, prof in osd.encode_service.stats()["profiles"].items():
        kind = label.split("[", 1)[0]
        for key in ("requests", "batches"):
            out[f"{kind}_{key}"] = out.get(f"{kind}_{key}", 0) + prof[key]
    return out


def service_growth(everyone: dict, base: dict) -> dict:
    """The encode-service counters' growth since `base` ({osd id: counts}),
    summed over the daemons in `everyone` (the killed ones' too)."""
    out: dict = {}
    for i, o in everyone.items():
        for k, v in service_counts(o).items():
            out[k] = out.get(k, 0) + v - base[i].get(k, 0)
    return out


def osd_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3i: the port's OSD daemons and RADOS client on the card.  The
    PUT in OSD_TRIALS trials, meta objects, every object read back, a ranged
    read and an unaligned 1 MiB overwrite (RMW), then one non-primary OSD
    holding data shards killed and marked down, all 16 objects of a trial
    read, two more killed (3 = m lost) and read again.  Every read against
    the written bytes, every shard's hinfo against encode_with_hinfo on
    the CPU, and the same writes (each PG's in the card's order) through
    a device="cpu" twin cluster against every store's shard objects,
    xattrs and logs.  Then phases 3j (recovery_steps, recovery_report) and
    3k (split_compute_steps, osd_compute_report) on the same cluster, its
    twin driven through the same history.  Returns the launches of the
    paths osd, recovery, recovery_msr, split and osd_compute."""
    import asyncio

    from ceph_tpu_torch.device import to_device
    from ceph_tpu_torch.ec import plan
    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.osd.osdmap import PgId
    from ceph_tpu_torch.common import tracing
    from ceph_tpu_torch.os import ObjectId
    from ceph_tpu_torch.rados.client import RadosClient, RadosError
    from ceph_tpu_torch.rados.embedded import HINFO_ATTR, shard_collection

    phase_t0 = time.perf_counter()
    payload = np.random.default_rng(SEED + 9).bytes(OSD_PUT)
    per_part = OSD_PART // OSD_OBJECT
    n_objs = OSD_PUT // OSD_OBJECT

    def names(trial):
        return [f"put{trial}.part{p}.{i}" for p in range(OSD_PUT // OSD_PART)
                for i in range(per_part)]

    def piece(j):
        return memoryview(payload)[j * OSD_OBJECT:(j + 1) * OSD_OBJECT]

    meta = {f"meta.{i}": np.random.default_rng(SEED + 10 + i).bytes(
        512 + 97 * i) for i in range(OSD_META_OBJECTS)}
    rmw_name, rmw_off = names(OSD_TRIALS - 1)[5], 1_000_003
    rmw_data = np.random.default_rng(SEED + 11).bytes(1 << 20)
    rmw_want_bytes = bytearray(piece(5))
    rmw_want_bytes[rmw_off:rmw_off + len(rmw_data)] = rmw_data
    range_off, range_len = 777_777, 1_234_567

    async def put(io, trial):
        """The 64 MiB PUT: four 16 MiB parts in flight, each part its
        four 4 MiB objects in order (the put processor's stripes)."""
        objs = names(trial)

        async def part(p):
            for i in range(per_part):
                j = p * per_part + i
                await io.write_full(objs[j], piece(j))
        await asyncio.gather(*(part(p) for p in range(OSD_PUT // OSD_PART)))

    async def get(io, trial):
        objs = names(trial)

        async def part(p):
            return [await io.read(objs[p * per_part + i])
                    for i in range(per_part)]
        got = await asyncio.gather(*(part(p)
                                     for p in range(OSD_PUT // OSD_PART)))
        return [b for part_objs in got for b in part_objs]

    async def writes(io, mio):
        """OSD_TRIALS PUTs, then the meta objects.  Returns each PUT's
        seconds."""
        put_s = []
        for trial in range(OSD_TRIALS):
            t0 = time.perf_counter()
            await put(io, trial)
            put_s.append(time.perf_counter() - t0)
        for name, data in meta.items():
            await mio.write_full(name, data)
        return put_s

    def data_of(name):
        return piece(names(int(name[3])).index(name))

    msr_objs = {f"msr.{i}": np.random.default_rng(SEED + 12 + i).bytes(
        OSD_OBJECT) for i in range(RECOVERY_MSR_OBJECTS)}
    tname = "traced.0"

    def tallies(everyone):
        """Per daemon object (a revived OSD is a new one): its perf
        counters, its encode service's counts, its compute and inference
        engines' counters and its tracer's recovery stage seconds."""
        out = {}
        for o in everyone:
            t = {f"perf.{k}": v for k, v in o.perf.items()}
            t.update({f"svc.{k}": v for k, v in service_counts(o).items()})
            t.update({f"compute.{k}": v
                      for k, v in o.compute.counters.items()})
            t.update({f"inference.{k}": v
                      for k, v in o.inference.counters.items()})
            t.update({f"stage.{k}": h.total
                      for k, h in o.tracer.stage_hist.items()
                      if k.startswith("recover_")})
            out[id(o)] = (o.osd_id, t)
        return out

    def since(base, everyone, per_osd=False):
        """Every counter's growth since `base`, summed over the daemons
        (or per OSD id)."""
        out: dict = {}
        for key, (osd_id, now) in tallies(everyone).items():
            was = base.get(key, (osd_id, {}))[1]
            tgt = out.setdefault(osd_id, {}) if per_osd else out
            for k, v in now.items():
                tgt[k] = tgt.get(k, 0) + v - was.get(k, 0)
        return out

    async def recovery_steps(mon, osds, stores, client, everyone, device,
                             plan=None):
        """Phase 3j on the cluster phase 3i left (its three victims dead
        and down): a. revive them; b. drain one more (kill, down, out),
        then the 64 MiB PUT while it is out; c. refill it (revive, in);
        the MSR pool's writes; d. one more OSD killed, down and out.  Each
        step ends clean.  With `plan` (the card run's victims and each
        PG's order of the PUT's writes) it replays that history, for the
        CPU twin; without, it counts the kernels on the paths `recovery`
        (a to c) and `recovery_msr` (d) and times the steps."""
        card_run = plan is None
        plan = dict(plan or {})
        addr = client.mon_addrs[0]
        data_id = mon.osdmap.lookup_pool("rgw.data")
        io = client.open_ioctx("rgw.data")
        out: dict = {"seconds": {}, "stages_s": {}, "counts": {}}

        async def revive(i):
            osd = OSDDaemon(i, [addr], store=stores[i],
                            config=dict(OSD_CONFIG), device=device)
            await osd.start()
            osds[i] = osd
            everyone.append(osd)

        async def command(prefix, i):
            rc, msg = await client.mon_command({"prefix": prefix, "osd": i})
            check(rc == 0, f"{prefix} {i}: {msg}")

        async def clean():
            await wait_clean(mon, osds)

        def window(name, base, step_s):
            """One counted path's launches and counters."""
            if card_run:
                out["launches"][name] = {n: fn.launches
                                         for n, fn in wrappers.items()}
            out["counts"][name] = since(base, everyone)
            out["per_osd"][name] = since(base, everyone, per_osd=True)
            out["seconds"].update(step_s)

        def acting_of(pool_id):
            pool = mon.osdmap.pools[pool_id]
            return {ps: mon.osdmap.pg_to_acting_osds(PgId(pool_id, ps))
                    for ps in range(pool.pg_num)}

        out["launches"], out["per_osd"] = {}, {}
        if card_run:
            for fn in wrappers.values():
                fn.launches = 0
        base = tallies(everyone)
        steps: dict = {}

        # a. revive 3i's victims: their PGs map back with nothing missing
        t0 = time.perf_counter()
        for v in sorted(set(range(OSD_OSDS)) - set(osds)):
            await revive(v)
        await clean()
        steps["a_revive_to_clean"] = time.perf_counter() - t0
        out["a_counts"] = since(base, everyone)

        # b. drain: an OSD holding data shards (not a primary where one
        # does), down and out; then the PUT while it is out
        before = acting_of(data_id)
        if card_run:
            primaries = {p for _a, p in before.values()}
            holders: dict = {}
            for acting, _p in before.values():
                for osd in acting[:K]:
                    holders[osd] = holders.get(osd, 0) + 1
            plan["b_victim"] = sorted(holders, key=lambda o: (
                o in primaries, -holders[o], o))[0]
        bv = plan["b_victim"]
        out["b_objects_to_rebuild"] = sum(
            bv in before[io.object_pg(n).ps][0]
            for n in [*(x for t in range(OSD_TRIALS) for x in names(t)),
                      tname])
        b_base = tallies(everyone)
        t0 = time.perf_counter()
        await osds.pop(bv).kill()
        await command("osd down", bv)
        await command("osd out", bv)
        await clean()
        steps["b_drain_to_clean"] = time.perf_counter() - t0
        out["b_counts"] = since(b_base, everyone)
        t0 = time.perf_counter()
        if card_run:
            await put(io, OSD_TRIALS)
        else:
            for _ps, oids in sorted(plan["put_order"].items()):
                for oid in oids:
                    await io.write_full(oid, data_of(oid))
        steps["b_put_while_out"] = time.perf_counter() - t0
        await clean()
        if card_run:
            plan["put_order"] = {
                ps: [e[0] for e in entries
                     if e[0].startswith(f"put{OSD_TRIALS}.")]
                for ps, entries in pg_logs(mon, stores, data_id).items()}

        # c. refill: revive it, mark it in; its PGs map back and its
        # missed shards (the PUT's) are recovered
        t0 = time.perf_counter()
        await revive(bv)
        await command("osd in", bv)
        await clean()
        steps["c_refill_to_clean"] = time.perf_counter() - t0
        window("recovery", base, steps)

        # the MSR pool, written outside the counted paths, and phase 3k's
        # models' pool, made here while a map epoch maps fewer PGs
        await client.create_ec_pool("msr.data", dict(RECOVERY_MSR_PROFILE),
                                    pg_num=8)
        msr_id = mon.osdmap.lookup_pool("msr.data")
        await client.create_ec_pool(MODEL_POOL, dict(MODEL_POOL_PROFILE),
                                    pg_num=MODEL_POOL_PGS)
        await clean()
        msr_io = client.open_ioctx("msr.data")
        for name, data in msr_objs.items():
            await msr_io.write_full(name, data)
        await clean()

        # d. one more OSD lost and out: MSR PGs rebuild its chunk from d
        # helpers' fragments.  The victim keeps some MSR primary free of
        # classic decodes (no RS PG it leads holds the victim), so that
        # primary's bytes read per byte rebuilt are the repair's alone.
        msr_acting = acting_of(msr_id)
        if card_run:
            rs_acting = acting_of(data_id)

            def clean_primaries(v):
                rs_led = {p for a, p in rs_acting.values() if v in a}
                return sum(1 for a, p in msr_acting.values()
                           if v in a and p != v and p not in rs_led)
            plan["d_victim"] = max(
                (o for o in range(OSD_OSDS) if o != bv),
                key=lambda o: (clean_primaries(o), -o))
        dv = plan["d_victim"]
        if card_run:
            for fn in wrappers.values():
                fn.launches = 0
        d_base = tallies(everyone)
        t0 = time.perf_counter()
        await osds.pop(dv).kill()
        await command("osd down", dv)
        await command("osd out", dv)
        await clean()
        window("recovery_msr", d_base,
               {"d_msr_loss_to_clean": time.perf_counter() - t0})
        out["msr_objects_to_rebuild"] = sum(
            dv in msr_acting[msr_io.object_pg(n).ps][0] for n in msr_objs)
        # the victim's shard in each object's PG: the lost chunk a rebuild
        # reconstructs (its matrix decides xor_sched or gf_matmul_gen)
        by_lost: dict = {}
        for n in msr_objs:
            acting = msr_acting[msr_io.object_pg(n).ps][0]
            if dv in acting:
                by_lost[acting.index(dv)] = by_lost.get(
                    acting.index(dv), 0) + 1
        out["msr_objects_by_lost_shard"] = by_lost
        out["plan"] = plan
        out["msr_id"] = msr_id
        out["msr_sinfo_width"] = next(iter(osds.values()))._sinfo(
            msr_id).get_stripe_width()
        return out

    scan_objs = scan_objects(OSD_SCAN_OBJECT)

    def osd_meta(stores):
        """Each store's split bookkeeping (its `osd_meta` collection)."""
        return {osd_id: store.omap_get("osd_meta", ObjectId("split_state"))
                for osd_id, store in sorted(stores.items())
                if store.collection_exists("osd_meta")}

    def spans_since(everyone, marks):
        """The spans each daemon retained since `marks` (its count of
        retained spans then)."""
        out = []
        for o in everyone:
            new = o.tracer.counters["spans_retained"] - marks.get(id(o), 0)
            if new > 0:
                out.extend(o.tracer.dump()[-new:])
        return out

    async def split_compute_steps(mon, osds, stores, client, everyone,
                                  device, plan=None):
        """Phase 3k on the cluster phase 3j left: a. rgw.data grows from 8
        to 32 PGs with every object at rest, every object is read back and
        one more 4 MiB object goes into a child PG; b. phase 3g's scan
        objects written, scanned with the linear kernels through the OSDs
        (and the nonlinear ones, which take the fallback); c. its two
        models stored and queried, exact and at the budget; then b's
        linear scans and c's queries again with one and with three data
        shards' OSDs down.  With `plan` (the card run's victims) it
        replays that history, for the CPU twin; without, it counts the
        kernels on the paths `split` (a) and `osd_compute` (b and c) and
        times them."""
        from ceph_tpu_torch.inference import registry

        card_run = plan is None
        plan = dict(plan or {})
        data_id = mon.osdmap.lookup_pool("rgw.data")
        io = client.open_ioctx("rgw.data")
        out: dict = {"seconds": {}, "launches": {}, "counts": {},
                     "answers": {}, "errors": {}, "subread_bytes": {},
                     "infer": {}, "specs": {}, "params": {},
                     "short_of_k": {}}

        def zero():
            if card_run:
                for fn in wrappers.values():
                    fn.launches = 0

        def window(name, base):
            if card_run:
                out["launches"][name] = {n: fn.launches
                                         for n, fn in wrappers.items()}
            out["counts"][name] = since(base, everyone)

        async def caught_up():
            while client.osdmap.epoch < mon.osdmap.epoch:
                await client.wait_for_new_map(1.0)

        steps_t0 = time.perf_counter()
        steps: dict = {}

        def step(name, t0):
            steps[name] = time.perf_counter() - t0
            return time.perf_counter()

        def shards_at_slots(name):
            """(shards held at their slots by the live acting members,
            those members)."""
            pg = io.object_pg(name)
            acting, _p = mon.osdmap.pg_to_acting_osds(pg)
            have = members = 0
            for slot, osd in enumerate(acting):
                if osd in osds:
                    members += 1
                    try:
                        stores[osd].stat(shard_collection(pg, slot),
                                         ObjectId(name))
                        have += 1
                    except (KeyError, IOError):
                        pass
            return have, members

        def missing_a_shard(oids):
            found = []
            for name in oids:
                have, members = shards_at_slots(name)
                if have < members:
                    found.append(name)
            return found

        def short_of_k(oids):
            return [n for n in oids if shards_at_slots(n)[0] < K]

        # a. the split
        rs_names = [n for t in range(OSD_TRIALS + 1) for n in names(t)] \
            + [tname]
        # healthy, before the split: the objects whose shard at some slot
        # is missing (reference fault C7, ROADMAP: 3j's out remap moved
        # a member's slot and left that slot's shards unrebuilt).  Only
        # these may later fall short of k; the split must add none.
        out["missing_before_split"] = missing_a_shard(rs_names)
        zero()
        base = tallies(everyone)
        old_pg_num = mon.osdmap.pools[data_id].pg_num
        t0 = time.perf_counter()
        rc, msg = await client.mon_command(
            {"prefix": "osd pool set", "name": "rgw.data", "var": "pg_num",
             "val": SPLIT_PG_NUM})
        check(rc == 0, f"osd pool set rgw.data pg_num: {msg}")
        await wait_clean(mon, osds)
        out["seconds"]["split_to_clean"] = time.perf_counter() - t0
        await caught_up()
        reads = [await io.read(n) == rs_want(n) for n in rs_names]
        split_name = next(f"split.{i}" for i in range(1 << 16)
                          if io.object_pg(f"split.{i}").ps >= old_pg_num)
        await io.write_full(split_name, piece(1))
        reads.append(await io.read(split_name) == piece(1))
        t1 = step("a_split_reads_write", t0)
        window("split", base)
        out.update(split_reads_exact=reads, split_name=split_name,
                   old_pg_num=old_pg_num,
                   missing_after_split=missing_a_shard(rs_names
                                                       + [split_name]))

        models_id = mon.osdmap.lookup_pool(MODEL_POOL)
        mio = client.open_ioctx(MODEL_POOL)
        short_client = RadosClient(client.mon_addrs, max_retries=2)
        await short_client.connect()

        # b. the scans through the OSDs
        zero()
        base = tallies(everyone)
        for name, data in scan_objs.items():
            await io.write_full(name, data)
        t1 = step("b_scan_object_writes", t1)
        targets = rs_names + [split_name] + list(scan_objs)

        def subread_bytes():
            return sum(o.perf["subread_bytes"] for o in everyone)

        async def scan(label, kname, oids, args=None, short=()):
            """One compute call over `oids`; the objects in `short` go
            in a second call, through a client that retries an EAGAIN
            twice, not the default 30 times."""
            before = subread_bytes()
            t0 = time.perf_counter()
            res, err = await io.compute(
                kname, [o for o in oids if o not in short], args)
            secs = time.perf_counter() - t0
            if short:
                res2, err2 = await short_client.open_ioctx(
                    "rgw.data").compute(kname, list(short), args)
                res, err = {**res, **res2}, {**err, **err2}
            out["answers"][label] = {o: bytes(r)
                                     for o, r in sorted(res.items())}
            out["errors"][label] = err
            out["subread_bytes"][label] = subread_bytes() - before
            return secs

        def below_k(spec):
            """Fewer than the model's k serving streams' holders up in
            its PG: the engine answers EAGAIN there (ROADMAP C9)."""
            acting, _p = mon.osdmap.pg_to_acting_osds(
                mio.object_pg(spec["params_oid"]))
            k, m = int(spec["k"]), int(spec["m"])
            return sum(o in osds and mon.osdmap.is_up(o)
                       for o in acting[:k + m]) < k

        async def serve(label, kind, spec, q):
            t0 = time.perf_counter()
            ex = await mio.infer(spec, q, exact=True)
            exact_s = time.perf_counter() - t0
            refusal = below_k(spec)
            t0 = time.perf_counter()
            # an expected EAGAIN goes through the client that retries
            # twice; any error's rc is held against the prediction
            served, rc = None, 0
            try:
                served = await (short_client.open_ioctx(MODEL_POOL)
                                if refusal else mio).infer(
                    spec, q, budget=MODEL_BUDGET)
            except RadosError as e:
                rc = e.rc
            out["infer"][f"{kind} {label}"] = {
                "exact": ex["scores"].tobytes(), "exact_mode": ex["mode"],
                "below_k": refusal, "rc": rc,
                "exact_s": exact_s, "served_s": time.perf_counter() - t0,
                **({"mode": served["mode"],
                    "est_error": served["est_error"],
                    "substituted": served["substituted"],
                    "scores": served["scores"].tobytes()}
                   if served is not None else {"mode": None})}

        out["short_of_k"]["data"] = short_of_k(targets)
        healthy_s = []
        t1 = step("b_short_of_k", t1)
        for _rep in range(OSD_SCAN_REPEATS if card_run else 1):
            marks = {id(o): o.tracer.counters["spans_retained"]
                     for o in everyone}
            healthy_s.append(await scan("data gf_fold", "gf_fold", targets))
        spans = spans_since(everyone, marks)
        out["scan_span_seconds"] = {
            stage: sum(sp["duration_us"] for sp in spans
                       if sp["name"].startswith(stage)) / 1e6
            for stage in ("compute_op", "compute eval", "compute decode",
                          "subcompute")}
        out["scan_span_counts"] = {
            stage: sum(sp["name"].startswith(stage) for sp in spans)
            for stage in out["scan_span_seconds"]}
        out["seconds"]["scan_gf_fold"] = healthy_s
        out["seconds"]["scan_gf_fingerprint"] = await scan(
            "data gf_fingerprint", "gf_fingerprint", targets)
        for i, (kn, obj, args) in enumerate(nonlinear_cases()):
            await scan(f"nonlinear {i}", kn, [obj], args)
        t1 = step("b_scans", t1)

        # c. the models, stored through the client and served by the OSDs
        models = {}
        for kind, dim, mout, hidden in OSD_MODELS:
            spec = await mio.store_model(
                f"m-{kind}", kind, registry.make_model(
                    kind, dim, mout, seed=SEED, hidden=hidden), m=MODEL_M)
            q = np.random.default_rng(SEED + dim).standard_normal(
                (MODEL_QUERIES, dim)).astype(np.float32)
            models[kind] = (spec, q)
            out["specs"][kind] = spec
            if card_run:
                out["params"][kind] = await mio.read(spec["params_oid"])
            await serve("data", kind, spec, q)
        t1 = step("c_models", t1)

        # b and c with one, then three data shards' OSDs down
        if card_run:
            acting = {pg: mon.osdmap.pg_to_acting_osds(pg)
                      for pg in {io.object_pg(n) for n in targets}}
            primaries = {p for _a, p in acting.values()}
            holders: dict = {}
            for a, _p in acting.values():
                for osd in a[:K]:
                    if osd in osds:
                        holders[osd] = holders.get(osd, 0) + 1
            plan["k3_victims"] = sorted(holders, key=lambda o: (
                o in primaries, -holders[o], o))[:3]
        victims = plan["k3_victims"]
        for label, kill in (("1_lost", victims[:1]),
                            ("3_lost", victims[1:3])):
            for v in kill:
                await osds.pop(v).kill()
                rc, msg = await client.mon_command(
                    {"prefix": "osd down", "osd": v})
                check(rc == 0, f"osd down {v}: {msg}")
            t1 = step(f"{label}_kill", t1)
            await pool_active(mon, osds, data_id)
            await caught_up()
            t1 = step(f"{label}_active", t1)
            out["short_of_k"][label] = short_of_k(targets)
            for kname in LINEAR_KERNELS:
                out["seconds"][f"scan_{kname}_{label}"] = await scan(
                    f"{label} {kname}", kname, targets,
                    short=out["short_of_k"][label])
            t1 = step(f"{label}_scans", t1)
            for kind, (spec, q) in models.items():
                await serve(label, kind, spec, q)
            t1 = step(f"{label}_queries", t1)
        await short_client.shutdown()
        window("osd_compute", base)
        out["plan"] = plan
        out["targets"] = targets
        out["sinfo_chunk"] = next(iter(osds.values()))._sinfo(
            data_id).get_chunk_size()
        out["final"] = final_state(mon, stores,
                                   mon.osdmap.lookup_pool("msr.data"))
        out["final"]["osd_meta"] = osd_meta(stores)
        out["final"]["models"] = snapshot(stores, models_id)
        step("snapshot", t1)
        steps["total"] = time.perf_counter() - steps_t0
        out["step_seconds"] = steps
        return out

    result: dict = {"phase": "osd", "osds": OSD_OSDS,
                    "hosts": OSD_OSDS // OSD_OSDS_PER_HOST,
                    "put_bytes": OSD_PUT, "object_bytes": OSD_OBJECT,
                    "trials": OSD_TRIALS, "card": card}
    exact = []

    async def drive():
        mon, osds, stores, client = await osd_cluster_start(dev)
        try:
            check(all(o.device.type == "cuda" for o in osds.values()),
                  "an OSD is not on the card")
            data_id = mon.osdmap.lookup_pool("rgw.data")
            meta_id = mon.osdmap.lookup_pool("rgw.meta")
            await pool_active(mon, osds, data_id)
            await pool_active(mon, osds, meta_id)
            io = client.open_ioctx("rgw.data")
            mio = client.open_ioctx("rgw.meta")
            # the main path, its counts zeroed just before it; every OSD
            # kept for its service's counters (the killed ones' too)
            everyone = dict(osds)
            for fn in wrappers.values():
                fn.launches = 0
            svc0 = {i: service_counts(o) for i, o in everyone.items()}
            put_s = await writes(io, mio)
            read_s = []
            for trial in range(OSD_TRIALS):
                t0 = time.perf_counter()
                got = await get(io, trial)
                read_s.append(time.perf_counter() - t0)
                exact.extend(g == piece(j) for j, g in enumerate(got))
            for name, data in meta.items():
                exact.append(await mio.read(name) == data)
            rng_got = await io.read(names(0)[3], range_off, range_len)
            exact.append(rng_got == piece(3)[range_off:range_off
                                              + range_len])
            t0 = time.perf_counter()
            await io.write(rmw_name, rmw_data, rmw_off)
            rmw_s = time.perf_counter() - t0
            rmw_want = bytearray(piece(5))
            rmw_want[rmw_off:rmw_off + len(rmw_data)] = rmw_data
            exact.append(await io.read(rmw_name) == bytes(rmw_want))
            snap = snapshot(stores, data_id)
            meta_snap = snapshot(stores, meta_id)
            logs = pg_logs(mon, stores, data_id)

            # one 4 MiB write_full traced end to end: the client's span,
            # the primary's op tree and the encode flush it rode
            client.trace_all = True
            t0 = time.perf_counter()
            await io.write_full(tname, piece(0))
            traced_s = time.perf_counter() - t0
            client.trace_all = False
            cspan = [s for s in client.tracer.dump()
                     if s["name"].endswith(tname)][-1]
            pg = io.object_pg(tname)
            _a, primary = mon.osdmap.pg_to_acting_osds(pg)
            tree = osds[primary].tracer.dump(int(cspan["trace_id"], 16))
            op = [s for s in tree if s["name"].startswith("osd_op")][0]
            cp = tracing.critical_path([s for s in tree])
            flushes = [s for s in osds[primary].tracer.dump()
                       if s["name"].startswith("encode_flush")
                       and f"{op['trace_id']}/{op['span_id']}"
                       in s.get("links", [])]
            sub_us = [s["duration_us"] for s in tree
                      if s["name"].startswith("subwrite")]
            result["write_4mib_breakdown_s"] = {
                "client_total": cspan["duration_us"] / 1e6,
                "host_clock_total": traced_s,
                "client_send_and_reply": (cspan["duration_us"]
                                          - op["duration_us"]) / 1e6,
                "primary_op": op["duration_us"] / 1e6,
                "encode_wait": sum(s["duration_us"] for s in tree
                                   if s["name"] == "encode_wait") / 1e6,
                "encode_dispatch": (flushes[0]["attrs"]["dispatch_ms"] / 1e3
                                    if flushes else None),
                "subwrite_fanout_and_commits": (max(sub_us) / 1e6
                                                if sub_us else None),
                "critical_path_stages_s": {k: v / 1e6 for k, v in
                                           cp["stages"].items()}}
            # the encode of that write alone is timed after the counts
            # are read: its launches are not the OSD path's
            codec = osds[primary]._codec(data_id)
            sinfo = osds[primary]._sinfo(data_id)
            arr = np.frombuffer(piece(0), np.uint8).reshape(
                -1, K, sinfo.get_chunk_size())

            # degraded reads: a non-primary OSD holding data shards, then
            # two more (3 lost = m); each marked down through the mon
            pgs = [io.object_pg(n) for t in range(OSD_TRIALS)
                   for n in names(t)]
            acting = {pg: mon.osdmap.pg_to_acting_osds(pg) for pg in pgs}
            primaries = {p for _a, p in acting.values()}
            holders: dict = {}
            for pg in pgs:
                for shard, osd in enumerate(acting[pg][0][:K]):
                    holders[osd] = holders.get(osd, 0) + 1
            order = sorted(holders, key=lambda o: (o in primaries,
                                                   -holders[o], o))
            victims = order[:3]
            deg_s = {}
            for key, kill in (("read_1_lost", victims[:1]),
                              ("read_3_lost", victims[1:3])):
                for v in kill:
                    await osds.pop(v).kill()
                    rc, out = await client.mon_command(
                        {"prefix": "osd down", "osd": v})
                    check(rc == 0, f"osd down {v}: {out}")
                await pool_active(mon, osds, data_id)
                deg_s[key] = []
                # each pass reads one PUT's objects once: the interval
                # change emptied the read tier, so every read decodes
                for trial in range(OSD_TRIALS):
                    t0 = time.perf_counter()
                    got = await get(io, trial)
                    deg_s[key].append(time.perf_counter() - t0)
                    want = [bytes(rmw_want) if names(trial)[j] == rmw_name
                            else piece(j) for j in range(n_objs)]
                    exact.extend(g == w for g, w in zip(got, want))
            launches = {n: fn.launches for n, fn in wrappers.items()}
            svc = service_growth(everyone, svc0)
            hist: dict = {}
            for o in everyone.values():
                for prof in o.encode_service.stats()["profiles"].values():
                    for size, cnt in prof["batch_size_hist"].items():
                        hist[size] = hist.get(size, 0) + cnt
            # the encode of one 4 MiB write alone, and the pinned
            # staging in it
            result["write_4mib_encode_s"] = {
                "encode_with_hinfo": host_median_s(
                    torch, lambda: ec_util.encode_with_hinfo(
                        sinfo, codec, piece(0), range(K + M),
                        logical_len=OSD_OBJECT)),
                "plan_encode_with_crc": host_median_s(
                    torch, lambda: plan.encode_with_crc(codec.matrix, arr,
                                                        dev)),
                "to_device_pinned_staging": host_median_s(
                    torch, lambda: to_device(arr, dev))}
            result.update({
                "launches": launches, "victims": victims,
                "victims_primary_of_a_data_pg": [v in primaries
                                                 for v in victims],
                "encode_service": svc, "batch_size_hist": hist,
                "seconds": {"put": put_s, "read": read_s, **deg_s,
                            "rmw_1mib": rmw_s}})
            # phases 3j and 3k on this cluster
            every = list(everyone.values())
            rec = await recovery_steps(mon, osds, stores, client, every,
                                       dev)
            rec["reads_exact"] = await read_all(client, rec["msr_id"])
            rec["final"] = final_state(mon, stores, rec["msr_id"])
            k3 = await split_compute_steps(mon, osds, stores, client,
                                           every, dev)
            return snap, meta_snap, logs, rec, k3
        finally:
            await osd_cluster_stop(mon, osds, client)

    def rs_want(name):
        return bytes(rmw_want_bytes) if name == rmw_name else \
            bytes(piece(0) if name == tname else data_of(name))

    async def read_all(client, msr_id):
        """Every object of the three pools read back against its bytes."""
        io = client.open_ioctx("rgw.data")
        mio = client.open_ioctx("rgw.meta")
        msr_io = client.open_ioctx("msr.data")
        got = []
        for name in [n for t in range(OSD_TRIALS + 1) for n in names(t)] \
                + [tname]:
            got.append(await io.read(name) == rs_want(name))
        for name, data in meta.items():
            got.append(await mio.read(name) == data)
        for name, data in msr_objs.items():
            got.append(await msr_io.read(name) == data)
        return got

    def final_state(mon, stores, msr_id):
        data_id = mon.osdmap.lookup_pool("rgw.data")
        meta_id = mon.osdmap.lookup_pool("rgw.meta")
        return {"data": snapshot(stores, data_id),
                "meta": snapshot(stores, meta_id),
                "msr": snapshot(stores, msr_id),
                "logs": {"data": pg_logs(mon, stores, data_id),
                         "msr": pg_logs(mon, stores, msr_id)}}

    async def drive_twin(logs, victims, rec_plan, k3_plan):
        """The same writes on a device="cpu" cluster, each PG's in the
        order its log took on the card (the parts in flight interleave
        there at the card's pace, and an object's version is its place
        in that order); then the traced write, the card's kills, phase
        3j's history (its PUT in the card's order too) and phase 3k's."""
        mon, osds, stores, client = await osd_cluster_start("cpu")
        try:
            data_id = mon.osdmap.lookup_pool("rgw.data")
            meta_id = mon.osdmap.lookup_pool("rgw.meta")
            await pool_active(mon, osds, data_id)
            await pool_active(mon, osds, meta_id)
            io = client.open_ioctx("rgw.data")
            mio = client.open_ioctx("rgw.meta")
            for ps, entries in sorted(logs.items()):
                for k, (oid, op, _v) in enumerate(entries):
                    check(op == "modify", f"pg {ps}: a {op} entry")
                    if oid == rmw_name and all(o != oid for o, _p, _w
                                               in entries[k + 1:]):
                        await io.write(oid, rmw_data, rmw_off)
                    else:
                        await io.write_full(oid, data_of(oid))
            for name, data in meta.items():
                await mio.write_full(name, data)
            out = (snapshot(stores, data_id), snapshot(stores, meta_id),
                   pg_logs(mon, stores, data_id))
            everyone = list(osds.values())
            await io.write_full(tname, piece(0))
            for v in victims:
                await osds.pop(v).kill()
                rc, msg = await client.mon_command(
                    {"prefix": "osd down", "osd": v})
                check(rc == 0, f"osd down {v}: {msg}")
            await pool_active(mon, osds, data_id)
            rec = await recovery_steps(mon, osds, stores, client, everyone,
                                       "cpu", plan=rec_plan)
            final = final_state(mon, stores, rec["msr_id"])
            k3 = await split_compute_steps(mon, osds, stores, client,
                                           everyone, "cpu", plan=k3_plan)
            return out + (final, k3)
        finally:
            await osd_cluster_stop(mon, osds, client)

    snap, meta_snap, logs, rec, k3 = asyncio.run(
        asyncio.wait_for(drive(), 3 * OSD_PHASE_TIMEOUT))
    twin, twin_meta, twin_logs, twin_final, twin_k3 = asyncio.run(
        asyncio.wait_for(drive_twin(logs, result["victims"], rec["plan"],
                                    k3["plan"]),
                         3 * OSD_PHASE_TIMEOUT))

    # every shard's hinfo against encode_with_hinfo on the CPU (the RMW'd
    # object's ledger is the twin's business: an overwrite clears it)
    cpu_codec = create_erasure_code({**OSD_PROFILE, "device": "cpu"})
    cpu_sinfo = ec_util.StripeInfo(K, K * 65536)
    want_hinfo = {}
    for j in range(n_objs):
        _s, h, _c = ec_util.encode_with_hinfo(cpu_sinfo, cpu_codec, piece(j),
                                              range(K + M))
        want_hinfo[j] = h.to_dict()
    hinfo_ok, hinfo_n = True, 0
    for (osd_id, cid, name), (_data, attrs) in snap.items():
        if not name.startswith("put") or name == rmw_name:
            continue
        j = names(int(name[3])).index(name)
        hinfo_ok = hinfo_ok and json.loads(attrs[HINFO_ATTR]) \
            == want_hinfo[j]
        hinfo_n += 1
    diff = sorted(k for k in set(snap) | set(twin)
                  if snap.get(k) != twin.get(k))
    same_as_twin = not diff and meta_snap == twin_meta \
        and logs == twin_logs
    launches = result["launches"]
    gib = OSD_PUT / (1 << 30)
    med = {k: statistics.median(v[1:] if k in ("put", "read") else v)
           for k, v in result["seconds"].items() if isinstance(v, list)}
    result.update({
        "reads_exact": sum(exact), "reads": len(exact),
        "hinfo_vs_cpu_encode_ok": hinfo_ok, "hinfo_shards_checked": hinfo_n,
        "same_as_cpu_twin": same_as_twin, "shard_objects": len(snap),
        "twin_differs_at": [list(k) for k in diff[:5]],
        "writes_per_pg": {ps: len(e) for ps, e in logs.items()},
        "median_s": med,
        "gib_per_s": {k: gib / v for k, v in med.items()
                      if k != "rmw_1mib"},
        "local_cluster_gib_per_s_64mib_object": PHASE_RESULTS.get(
            "cluster", {}).get("gib_per_s"),
        "seconds_in_phase": time.perf_counter() - phase_t0})
    PHASE_RESULTS["osd"] = result["gib_per_s"]
    print(json.dumps(result))
    check(all(exact), "an OSD-path read differs from the written bytes")
    check(hinfo_ok and hinfo_n >= n_objs * (K + M),
          "a shard's hinfo differs from encode_with_hinfo on the CPU")
    check(same_as_twin, "the card cluster's shard objects or xattrs differ"
          " from the CPU twin's")
    # each encode-service batch of whole-object writes is one fused call
    # (one GF launch, two crc launches), each RMW re-encode batch one GF
    # launch; each decode batch one GF launch per survivor set in it
    svc = result["encode_service"]
    hinfo_b, enc_b = (svc.get("encode_hinfo_batches", 0),
                      svc.get("encode_batches", 0))
    check(hinfo_b > 0 and enc_b > 0
          and launches["gf_matmul_spec"] == hinfo_b + enc_b
          and launches["crc32c_blocks"] == 2 * hinfo_b,
          f"the OSD path's GF and crc launches {launches} are not its"
          f" encode service's batches {svc}")
    check(0 < svc.get("decode_batches", 0) <= launches["gf_matmul_gen"]
          <= svc.get("decode_requests", 0),
          f"the OSD path's decode launches {launches} are not its encode"
          f" service's decode batches {svc}")
    rec_launches = recovery_report(dev, card, rec, twin_final, rs_want,
                                   rmw_name, msr_objs)

    def k3_want(name):
        if name in scan_objs:
            return scan_objs[name]
        return bytes(piece(1)) if name == k3["split_name"] else rs_want(name)
    k3_launches = osd_compute_report(dev, card, k3, twin_k3, k3_want)
    return {"osd": launches, **rec_launches, **k3_launches}


def recovery_report(dev, card: str, rec: dict, twin: dict, rs_want,
                    rmw_name: str, msr_objs: dict) -> dict:
    """Phase 3j's checks and line: reads, every shard object against the
    CPU encode of its object (bytes and hinfo), the card's stores and pg
    logs against the CPU twin's, the kernels at the paths' shapes against
    their plain versions, and each path's launches against its counters.
    Returns the launches of the paths `recovery` and `recovery_msr`."""
    import torch

    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.models import reed_solomon as rs
    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.rados.embedded import HINFO_ATTR

    final = rec["final"]
    msr_k = int(RECOVERY_MSR_PROFILE["k"])
    # every shard object on every store against the CPU encode of its
    # object (the RMW'd object's ledger is cleared by its overwrite: its
    # bytes here, its xattrs against the twin)
    cpu = {"data": (create_erasure_code({**OSD_PROFILE, "device": "cpu"}),
                    ec_util.StripeInfo(K, K * 65536), rs_want),
           "msr": (create_erasure_code({**RECOVERY_MSR_PROFILE,
                                        "device": "cpu"}),
                   ec_util.StripeInfo(msr_k, rec["msr_sinfo_width"]),
                   msr_objs.__getitem__)}
    bad_shards, shards_checked, cache = [], 0, {}
    for pool in ("data", "msr"):
        codec, sinfo, want = cpu[pool]
        for (osd_id, cid, name), (data, attrs) in final[pool].items():
            shard = int(cid.rsplit("s", 1)[1].split("_")[0])
            if (pool, name) not in cache:
                obj = bytes(want(name))     # padded as the OSD pads it
                obj += bytes(-len(obj) % sinfo.get_stripe_width())
                shards, h, _c = ec_util.encode_with_hinfo(
                    sinfo, codec, obj, range(codec.get_chunk_count()))
                cache[(pool, name)] = (
                    {i: bytes(v) for i, v in shards.items()}, h.to_dict())
            exp, hinfo = cache[(pool, name)]
            ok = bytes(data) == exp[shard]
            if name != rmw_name:
                ok = ok and json.loads(attrs[HINFO_ATTR]) == hinfo
            if not ok:
                bad_shards.append([osd_id, cid, name])
            shards_checked += 1
    diff = {part: sorted(k for k in set(final[part]) | set(twin[part])
                         if final[part].get(k) != twin[part].get(k))
            for part in ("data", "meta", "msr")}
    same_as_twin = not any(diff.values()) and final["logs"] == twin["logs"]

    # the kernels at the paths' shapes against their plain versions: a
    # 4 MiB object's decode (8 stripes of 64 KiB units) and a group of 16
    # sharing a survivor set, a 16-object wave's re-encode, and MSR's
    # helper projection and (alpha x d) rebuild of four objects' chunks
    rs_mat = rs.reed_sol_van_matrix(K, M)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)

    def rand_dev(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    from ceph_tpu_torch.ec import plan as tplan
    from ceph_tpu_torch.ec import xsched as txsched
    from ceph_tpu_torch.ops import xor_kernels

    one_lost = rs.decode_matrix(rs_mat, K, [0], list(range(1, K + 1)))
    msr = create_erasure_code({**RECOVERY_MSR_PROFILE, "device": str(dev)})
    alpha, d = msr.get_sub_chunk_count(), msr.repair_degree()
    width = rec["msr_sinfo_width"]
    msr_chunk = width // msr_k * -(-OSD_OBJECT // width)
    cases = {
        "decode 1 lost (8, 8, 65536)": ("gen", one_lost,
                                        rand_dev(8, K, 65536)),
        "decode 1 lost (128, 8, 65536)": ("gen", one_lost,
                                          rand_dev(128, K, 65536)),
        "re-encode (128, 8, 65536)": ("spec", rs_mat,
                                      rand_dev(128, K, 65536)),
        "msr project (1, alpha, chunk/alpha)": (
            "gen", msr.repair_vector(0)[None, :],
            rand_dev(1, alpha, msr_chunk // alpha)),
        "msr rebuild (1, d, 4 chunks/alpha)": (
            "gen", msr.repair_matrix(0, tuple(range(1, d + 1))),
            rand_dev(1, d, 4 * msr_chunk // alpha))}
    kernel_errs = {}
    for label, (kind, mat, x) in cases.items():
        fn = getattr(gf_kernels, f"gf_matmul_{kind}")
        plain = getattr(gf_kernels, f"gf_matmul_{kind}_plain")
        kernel_errs[label] = err(fn(mat, x), plain(mat, x))
    # the rebuilds the schedule pick takes run on xor_sched's GF entry:
    # which lost chunks' (alpha x d) matrices it takes, and the entry at
    # the rebuild shape against the GF product's plain version
    n_msr = msr.get_chunk_count()
    picked = set()
    for lost in range(n_msr):
        sched = tplan._sched_for(msr.repair_matrix(
            lost, tuple(h for h in range(n_msr) if h != lost)))
        if sched is not None and txsched.prefer_schedule(sched):
            picked.add(lost)
    rmat = msr.repair_matrix(min(picked), tuple(
        h for h in range(n_msr) if h != min(picked))) if picked else None
    if rmat is not None:
        x = rand_dev(1, d, 4 * msr_chunk // alpha // 4 * 4)
        kernel_errs["msr rebuild (1, d, 4 chunks/alpha) on xor_sched"] = err(
            xor_kernels.xor_sched_gf(txsched.lower_program(
                tplan._sched_for(rmat)), x),
            gf_kernels.gf_matmul_gen_plain(rmat, x))
    xor_objects = sum(v for lost, v in rec["msr_objects_by_lost_shard"]
                      .items() if lost in picked)

    # each path's launches against its counters (every OSD's, the killed
    # and revived daemons' too)
    lr, lm = rec["launches"]["recovery"], rec["launches"]["recovery_msr"]
    cr, cm = rec["counts"]["recovery"], rec["counts"]["recovery_msr"]

    def c(counts, key):
        return counts.get(key, 0)
    hinfo_b = c(cr, "svc.encode_hinfo_batches")
    launches_ok = {
        # one launch per survivor set in each of the service's decode
        # batches (a decode with every data shard at hand stays on the
        # host and out of the batches); a wave's decodes can take more
        # than one batch (an idle bucket flushes its first request alone)
        "recovery_gen": 1 <= c(cr, "svc.decode_batches")
        <= lr["gf_matmul_gen"] <= c(cr, "svc.decode_requests"),
        # one re-encode a wave, one fused write a service batch
        "recovery_spec": hinfo_b > 0 and lr["gf_matmul_spec"]
        == c(cr, "perf.encode_dispatches") + hinfo_b,
        "recovery_crc": lr["crc32c_blocks"] == 2 * hinfo_b,
        "recovery_batched": 0 < c(rec["b_counts"], "perf.decode_dispatches")
        < rec["b_objects_to_rebuild"],
        # MSR: one projection a fragment (on its helper; the pick refuses
        # the (1 x alpha) vectors: gf_matmul_gen) and one rebuild a (lost,
        # helper set) group, on xor_sched's GF entry where the pick takes
        # the (alpha x d) matrix, else on gen, beside step d's RS decodes
        "msr_gen_and_xor_sched": c(cm, "perf.repair_fragments")
        + min(1, c(cm, "perf.repair_objects"))
        + c(cm, "svc.decode_batches")
        <= lm["gf_matmul_gen"] + lm["xor_sched_gf"]
        <= c(cm, "svc.decode_requests") + c(cm, "perf.repair_objects")
        + c(cm, "perf.repair_fragments"),
        "msr_projections_on_gen": lm["gf_matmul_gen"]
        >= c(cm, "perf.repair_fragments"),
        "msr_rebuilds_on_xor_sched": min(1, xor_objects)
        <= lm["xor_sched_gf"] <= xor_objects,
        "msr_spec": lm["gf_matmul_spec"] == c(cm, "perf.encode_dispatches"),
        "msr_crc": lm["crc32c_blocks"] == 0}
    # MSR: every rebuild from d fragments, and on the primaries that ran
    # no classic decode in the step, bytes read <= (d / alpha + slack) x
    # bytes rebuilt (tests/test_msr.py's check)
    repaired = c(cm, "perf.repair_objects")
    ratios = {osd: per["perf.recovery_bytes_read"]
              / per["perf.recovery_bytes_repaired"]
              for osd, per in rec["per_osd"]["recovery_msr"].items()
              if per.get("perf.repair_objects", 0) > 0
              and per.get("perf.decode_dispatches", 0) == 0
              and per.get("perf.recovery_bytes_repaired", 0) > 0}
    msr_ok = {
        "repair_objects": 0 < repaired <= rec["msr_objects_to_rebuild"],
        "fragments": c(cm, "perf.repair_fragments") >= d * repaired,
        "no_fallback": c(cm, "perf.repair_fallbacks") == 0,
        "bytes_read_per_byte_rebuilt": bool(ratios) and all(
            r <= d / alpha + RECOVERY_MSR_SLACK for r in ratios.values())}

    def stages(counts):
        return {k[len("stage."):]: v for k, v in counts.items()
                if k.startswith("stage.")}
    secs = rec["seconds"]
    to_clean = {"b": secs["b_drain_to_clean"],
                "c": secs["c_refill_to_clean"],
                "d": secs["d_msr_loss_to_clean"]}
    rebuilt_b = c(rec["b_counts"], "perf.recovery_bytes_repaired")
    rebuilt = {"b": rebuilt_b,
               "c": c(cr, "perf.recovery_bytes_repaired") - rebuilt_b,
               "d": c(cm, "perf.recovery_bytes_repaired")}
    out = {"phase": "recovery", "card": card,
           "plan": {k: v for k, v in rec["plan"].items()
                    if k != "put_order"},
           "seconds": secs, "seconds_to_clean": to_clean,
           "bytes_rebuilt": rebuilt,
           "gib_per_s_rebuilt": {k: rebuilt[k] / (1 << 30) / to_clean[k]
                                 for k in to_clean},
           "stage_seconds": {"recovery": stages(cr),
                             "recovery_msr": stages(cm)},
           "a_recovered_bytes": c(rec["a_counts"],
                                  "perf.recovery_bytes_repaired"),
           "b_objects_to_rebuild": rec["b_objects_to_rebuild"],
           "msr_objects_to_rebuild": rec["msr_objects_to_rebuild"],
           "counters": {path: {k: v for k, v in counts.items()
                               if not k.startswith("stage.") and v}
                        for path, counts in rec["counts"].items()},
           "launches": rec["launches"], "launches_ok": launches_ok,
           "msr": {**msr_ok, "alpha": alpha, "d": d,
                   "ratios_on_clean_primaries": ratios,
                   "rebuilds_on_xor_sched_for_lost": sorted(picked),
                   "objects_by_lost_shard": rec["msr_objects_by_lost_shard"],
                   "objects_on_xor_sched": xor_objects},
           "reads_exact": sum(rec["reads_exact"]),
           "reads": len(rec["reads_exact"]),
           "shards_vs_cpu_encode_checked": shards_checked,
           "shards_vs_cpu_encode_bad": bad_shards[:5],
           "same_as_cpu_twin": same_as_twin,
           "twin_differs_at": {k: [list(x) for x in v[:3]]
                               for k, v in diff.items()},
           "kernel_vs_plain": kernel_errs}
    print(json.dumps(out))
    check(all(rec["reads_exact"]), "a read after recovery differs from the"
          " written bytes")
    check(out["a_recovered_bytes"] == 0, "the revived OSDs' PGs recovered"
          " something, but they missed no write")
    check(not bad_shards and shards_checked > 0, "a shard object differs"
          " from the CPU encode of its object")
    check(same_as_twin, "the card cluster's stores or pg logs after"
          " recovery differ from the CPU twin's")
    check(all(e == 0 for e in kernel_errs.values()), "a kernel disagrees"
          " with its plain version at the recovery paths' shapes")
    check(all(launches_ok.values()), "the recovery paths' launches do not"
          f" match their counters: {launches_ok}")
    check(all(msr_ok.values()), f"MSR repair checks failed: {msr_ok}")
    return {"recovery": lr, "recovery_msr": lm}


def osd_compute_report(dev, card: str, k3: dict, twin: dict,
                       want) -> dict:
    """Phase 3k's checks and lines: the split's reads, every store (the
    `osd_meta` split bookkeeping included) and pg log against the CPU
    twin's; every scan answer against kernel.reference on the bytes the
    smoke wrote, against phase 3g's library answer and against the twin's
    scan; the served queries against model.exact_forward, the budget and
    the twin; each path's launches against the engines' and the encode
    service's counters.  Returns the launches of the paths `split` and
    `osd_compute`."""
    from ceph_tpu_torch import compute
    from ceph_tpu_torch.inference import model

    report_t0 = time.perf_counter()
    final, tfinal = k3["final"], twin["final"]
    diff = {part: sorted(k for k in set(final[part]) | set(tfinal[part])
                         if final[part].get(k) != tfinal[part].get(k))
            for part in ("data", "meta", "msr", "models")}
    same_as_twin = {
        "stores": not any(diff.values()),
        "pg_logs": final["logs"] == tfinal["logs"],
        "osd_meta": final["osd_meta"] == tfinal["osd_meta"]
        and bool(final["osd_meta"]),
        "answers": k3["answers"] == twin["answers"]
        and k3["errors"] == twin["errors"]}

    # every answer against the host reference on the written bytes
    chunk = k3["sinfo_chunk"]
    library = PHASE_RESULTS.get("compute") \
        if OSD_SCAN_OBJECT == CLUSTER_OBJECT else None
    answers_ok, vs_library = {}, {}
    refs = {}
    # an object short of k shards answers EAGAIN, as the JAX OSDs answer
    # it; only an object that C7 left missing a shard before the split,
    # and that still misses one after it, may fall short (checked below),
    # every other object answers its value
    short = k3["short_of_k"]
    before, after = (set(k3["missing_before_split"]),
                     set(k3["missing_after_split"]))
    c7 = before & after
    c7_ok = {
        "split_adds_no_missing_shard": after <= before,
        "none_short_when_healthy": not short["data"],
        **{f"short_at_{stage}_were_missing_before": set(names) <= c7
           for stage, names in short.items()}}
    for kname in LINEAR_KERNELS:
        kern = compute.get_kernel(kname)
        # 3i's trials repeat the same 16 pieces: one reference a content
        by_bytes: dict = {}
        refs[kname] = {}
        for name in k3["targets"]:
            data = want(name)
            if data not in by_bytes:
                by_bytes[data] = kern.reference(data, {}, k=K, chunk=chunk)
            refs[kname][name] = by_bytes[data]
        for label, got in k3["answers"].items():
            if label.endswith(f" {kname}"):
                stage = label.split()[0]
                answers_ok[label] = got == {
                    name: ans for name, ans in refs[kname].items()
                    if name not in short[stage]}
    if library is not None:
        # gf_fold XORs every 32-byte lane of the object, whatever its
        # striping; 3g striped at 4 KiB units, rgw.data at 64 KiB
        vs_library["gf_fold"] = all(
            k3["answers"]["data gf_fold"][name] == ans
            for name, ans in library["answers"]["gf_fold"].items())
    for i, (kn, obj, args) in enumerate(nonlinear_cases()):
        got = k3["answers"][f"nonlinear {i}"].get(obj)
        # on the card: the CPU twin's answers are the same function on
        # the CPU, held above
        answers_ok[f"nonlinear {i} {kn}"] = got == compute.get_kernel(
            kn).reference(want(obj), args, k=K, chunk=chunk, device=dev)
        if library is not None:
            vs_library[f"{kn} {obj}"] = got == library["nonlinear"][i]
    errors = {label: {name: rc for name, rc in err.items()
                      if not (rc == EAGAIN_RC and name in c7
                              and name in short.get(label.split()[0], ()))}
              for label, err in k3["errors"].items()}
    errors = {label: err for label, err in errors.items() if err}
    linear_subreads = {label: n for label, n in k3["subread_bytes"].items()
                       if label.split()[-1] in LINEAR_KERNELS}

    # the served queries
    infer_ok, infer_line = {}, {}
    for label, got in k3["infer"].items():
        kind, stage = label.split()
        spec = k3["specs"][kind]
        dim = int(spec["dim"])
        q = np.random.default_rng(SEED + dim).standard_normal(
            (MODEL_QUERIES, dim)).astype(np.float32)
        exact = np.frombuffer(got["exact"], "<f4").reshape(MODEL_QUERIES, -1)
        want_exact = model.exact_forward(spec, k3["params"][kind], q)
        rel_exact = float(np.linalg.norm(exact - want_exact)
                          / np.linalg.norm(want_exact))
        rel_served = None
        if got["rc"] == 0:
            served = np.frombuffer(got["scores"], "<f4").reshape(
                exact.shape)
            rel_served = float(np.linalg.norm(served - exact)
                               / np.linalg.norm(exact))
        tw = twin["infer"][label]
        # the exact path is a refusal of the budget; EAGAIN (fewer than k
        # serving streams' holders up) a refusal of the query
        refused = got["mode"] == "exact"
        infer_line[label] = {
            "mode": got["mode"], "twin_mode": tw["mode"], "rc": got["rc"],
            "below_k": got["below_k"],
            "est_error": got.get("est_error"), "rel_error": rel_served,
            "substituted": got.get("substituted"),
            "exact_rel_error": rel_exact,
            "qps_exact": MODEL_QUERIES / got["exact_s"],
            "qps_served": MODEL_QUERIES / got["served_s"]}
        infer_ok[label] = {
            "exact": got["exact_mode"] == "exact"
            and rel_exact <= INFER_RTOL,
            "exact_same_as_twin": got["exact"] == tw["exact"],
            "eagain_where_below_k": got["rc"] == (
                EAGAIN_RC if got["below_k"] else 0),
            "refused_where_twin_refuses": (got["rc"], refused)
            == (tw["rc"], tw["mode"] == "exact"),
            "within_budget": got["rc"] != 0 or refused or (
                got["est_error"] <= MODEL_BUDGET
                and rel_served <= MODEL_BUDGET),
            # healthy, the models' pool serves every query from the
            # shards
            "served_healthy": stage != "data"
            or (got["rc"] == 0 and not refused)}

    # each path's launches against its counters
    sl, sc = k3["launches"]["split"], k3["counts"]["split"]
    ol, oc = k3["launches"]["osd_compute"], k3["counts"]["osd_compute"]

    def c(counts, key):
        return counts.get(key, 0)
    def writes(counts):
        """Fused whole-object encodes: the service's batches and the
        writes it shed to the inline path (too many bytes queued: the
        64 MiB objects), one GF and two crc launches each."""
        return c(counts, "svc.encode_hinfo_batches") \
            + c(counts, "svc.shed_encode_hinfo")
    launches_ok = {
        # the split's writes and its children's recovery (re-encodes and
        # decodes through the encode service), as in phase 3j
        "split_spec": writes(sc) > 0
        and sl["gf_matmul_spec"] == c(sc, "perf.encode_dispatches")
        + writes(sc),
        "split_crc": sl["crc32c_blocks"] == 2 * writes(sc),
        "split_gen": c(sc, "svc.decode_batches") <= sl["gf_matmul_gen"]
        <= c(sc, "svc.decode_requests") + c(sc, "svc.shed_decode"),
        # one fold launch at least per pushed-down PG wave, at most one
        # per length group of every sub-compute's local shards
        "osd_compute_fold": 1 <= c(oc, "compute.pushdown_waves")
        <= ol["gf_fold"] <= c(oc, "compute.fold_groups"),
        # a data shard's result lost: result-domain decodes at lane width,
        # at most one launch per survivor-set group missing a data shard,
        # beside the exact path's degraded reads through the encode service
        # (batched or shed)
        "osd_compute_gen": 1 <= c(oc, "compute.result_decode_groups")
        and 1 <= ol["gf_matmul_gen"]
        <= c(oc, "compute.result_decode_groups")
        + c(oc, "svc.decode_requests") + c(oc, "svc.shed_decode"),
        "osd_compute_spec": writes(oc) > 0
        and ol["gf_matmul_spec"] == c(oc, "perf.encode_dispatches")
        + writes(oc),
        "osd_compute_crc": ol["crc32c_blocks"] == 2 * writes(oc),
        "osd_compute_score": ol["score_blocks"] >= 1}

    secs = k3["seconds"]
    scan_s = statistics.median(secs["scan_gf_fold"])
    shard_bytes = sum(len(want(name)) for name in k3["targets"]) \
        * (K + M) / K
    out = {"phase": "split_and_osd_compute", "card": card,
           "step_seconds": k3["step_seconds"],
           "twin_step_seconds": twin["step_seconds"],
           "plan": k3["plan"], "split_pg_num": [k3["old_pg_num"],
                                                SPLIT_PG_NUM],
           "split_seconds_to_clean": secs["split_to_clean"],
           "split_name": k3["split_name"],
           "split_reads_exact": sum(k3["split_reads_exact"]),
           "split_reads": len(k3["split_reads_exact"]),
           "scanned_objects": len(k3["targets"]),
           "missing_a_shard_before_split_c7": k3["missing_before_split"],
           "missing_a_shard_after_split": k3["missing_after_split"],
           "short_of_k": short, "c7_checks": c7_ok,
           "scan_shard_gib": shard_bytes / (1 << 30),
           "scan_seconds": {k: v for k, v in secs.items()
                            if k.startswith("scan_")},
           "osd_scan_gib_per_s": shard_bytes / (1 << 30) / scan_s,
           "library_scan_gib_per_s": (library or {}).get("scan_gib_per_s"),
           "scan_span_seconds": k3["scan_span_seconds"],
           "scan_span_counts": k3["scan_span_counts"],
           "inference": infer_line,
           "library_inference_qps": (library or {}).get("inference_qps"),
           "answers_vs_reference": answers_ok,
           "answers_vs_library": vs_library,
           "scan_errors": errors, "linear_subread_bytes": linear_subreads,
           "same_as_cpu_twin": same_as_twin,
           "twin_differs_at": {k: [list(x) for x in v[:3]]
                               for k, v in diff.items()},
           "counters": {path: {k: v for k, v in counts.items() if v}
                        for path, counts in k3["counts"].items()},
           "launches": k3["launches"], "launches_ok": launches_ok,
           "report_seconds": time.perf_counter() - report_t0}
    print(json.dumps(out))
    check(all(k3["split_reads_exact"]), "a read after the split differs"
          " from the written bytes")
    check(all(same_as_twin.values()), "the card cluster's stores, pg logs,"
          f" osd_meta or scan answers differ from the CPU twin's:"
          f" {same_as_twin}")
    check(all(c7_ok.values()), "an object fell short of a shard that C7"
          f" had not left missing before the split: {c7_ok}")
    check(not errors, "a scanned object did not answer rc 0 (or EAGAIN,"
          f" where C7 left it short of k shards): {errors}")
    check(not any(linear_subreads.values()), "a linear scan moved sub-read"
          f" bytes: {linear_subreads}")
    check(all(answers_ok.values()), "a scan answer differs from"
          f" kernel.reference: {answers_ok}")
    check(all(vs_library.values()), "an OSD scan answer differs from phase"
          f" 3g's library answer: {vs_library}")
    check(all(all(v.values()) for v in infer_ok.values()),
          f"a served query failed its checks: {infer_ok}")
    check(all(launches_ok.values()), "the split or OSD compute paths'"
          f" launches do not match their counters: {launches_ok}")
    return {"split": sl, "osd_compute": ol}


# phase 3l: config 5 through the gateway, on a fresh cluster of 3i's shape
# (bench.py:3252-3300): the port's S3Frontend on loopback over a port
# RGWLite, the 64 MiB multipart PUT over HTTP (SigV4 by sign_request) as four
# 16 MiB parts in flight together, 2 trials (the first warms), each trial its
# own key; GETs whole and by a range, the listing, a 9 MB atomic PUT and a
# DELETE; outside HTTP, numops add on each pool, hello record_hello (an
# object-class write down the EC path) and a watch/notify round trip between
# two RADOS clients; then one OSD holding data shards killed and marked down
# and every object read again
RGW_ACCESS, RGW_SECRET = "AKIDCHIPSMOKE", "chip-smoke-secret"
RGW_BUCKET = "config5"
RGW_ATOMIC = 9_000_000
RGW_RANGE = (777_777, 1_234_567)
RGW_INDEX_BURST = 16        # object-ACL flips: bucket-index updates only
RGW_PHASE_TIMEOUT = 600.0


class S3Client:
    """A raw-socket HTTP/1.1 S3 client: one keep-alive connection, each
    request signed with the port's sign_request (SigV4)."""

    def __init__(self, addr: str):
        self.host, port = addr.rsplit(":", 1)
        self.port = int(port)
        self._r = self._w = None

    async def request(self, method: str, path: str, query=None,
                      body: bytes = b"", headers=None):
        import asyncio
        import urllib.parse

        from ceph_tpu_torch.rgw.s3_frontend import sign_request

        if self._w is None or self._w.is_closing():
            self._r, self._w = await asyncio.open_connection(
                self.host, self.port, limit=8 << 20)
        query = query or {}
        hdrs = sign_request(method, path, query,
                            {"Host": f"{self.host}:{self.port}",
                             **(headers or {})},
                            body, RGW_ACCESS, RGW_SECRET)
        qs = urllib.parse.urlencode(query)
        hdrs["Content-Length"] = str(len(body))
        head = "".join([f"{method} {path}{'?' + qs if qs else ''}"
                        " HTTP/1.1\r\n"]
                       + [f"{k}: {v}\r\n" for k, v in hdrs.items()]
                       + ["\r\n"])
        self._w.write(head.encode())
        self._w.write(body)
        await self._w.drain()
        status = int((await self._r.readline()).split()[1])
        rhdrs = {}
        while True:
            line = await self._r.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            rhdrs[k.strip().lower()] = v.strip()
        length = int(rhdrs.get("content-length", "0"))
        rbody = await self._r.readexactly(length) \
            if length and method != "HEAD" else b""
        return status, rhdrs, rbody

    async def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


class Recorder:
    """An IoCtx whose successful mutations are recorded per object, in the
    order they completed, as (method, args): the history a twin cluster
    replays in the card's pg-log order."""

    MUTATIONS = frozenset({"write_full", "write", "append", "remove",
                           "setxattr", "rmxattr", "omap_set",
                           "omap_rm_keys", "execute"})

    def __init__(self, io, calls: dict):
        self._io = io
        self.calls = calls

    def __getattr__(self, name):
        attr = getattr(self._io, name)
        if name not in self.MUTATIONS:
            return attr

        async def call(oid, *args, **kw):
            out = await attr(oid, *args, **kw)
            self.calls.setdefault(oid, []).append((name, args, kw))
            return out
        return call


async def replay(io, calls: dict, logs: dict) -> None:
    """Each PG's recorded mutations through `io` in the order of the PG's
    log on the card: an entry runs its object's next recorded call (a call
    that logged two entries, a class method's write and xattr, runs at the
    first)."""
    pending = {oid: list(c) for oid, c in calls.items()}
    for _ps, entries in sorted(logs.items()):
        for oid, _op, _v in entries:
            todo = pending.get(oid)
            if todo:
                name, args, kw = todo.pop(0)
                await getattr(io, name)(oid, *args, **kw)
    left = sorted(oid for oid, c in pending.items() if c)
    check(not left, f"recorded calls not in any pg log: {left[:5]}")


def rgw_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3l: BASELINE config 5 through the port's S3 gateway (path
    `rgw`), on a fresh 12-OSD cluster of 3i's shape on the card, its counts
    zeroed once the pools are active.  Checks: every GET and ranged GET
    against the written bytes, the listing's keys and sizes; numops' sums,
    the greeting, the notify acked by the watcher; the card's stores
    (shard objects and xattrs of both pools, the meta pool's omap) and pg
    logs against a device="cpu" twin that replays the card's RADOS
    mutations in each PG's log order; the kernels at the path's shapes
    against their plain versions; gf_matmul_spec = the encode service's
    whole-object batches and sheds plus its RMW batches, crc32c_blocks =
    2 x the whole-object ones, gf_matmul_gen within the service's decode
    batches and requests, and so in the degraded GETs alone with at least
    one launch (healthy GETs decode too where the first k shards to answer
    hold a parity shard), and no launch at all in a burst of bucket-index
    updates.  Returns the path's launches."""
    import asyncio
    import hashlib
    import xml.etree.ElementTree as ET

    from ceph_tpu_torch.models import reed_solomon as rs
    from ceph_tpu_torch.ops import checksum as cks
    from ceph_tpu_torch.ops import crc_kernels, gf_kernels
    from ceph_tpu_torch.rados.client import RadosClient, RadosError
    from ceph_tpu_torch.rgw import RGWLite
    from ceph_tpu_torch.rgw.s3_frontend import S3Frontend

    phase_t0 = time.perf_counter()
    payload = np.random.default_rng(SEED + 20).bytes(OSD_PUT)
    atomic = np.random.default_rng(SEED + 21).bytes(RGW_ATOMIC)
    n_parts = OSD_PUT // OSD_PART
    keys = [f"big.{t}" for t in range(OSD_TRIALS)]
    lo, n_range = RGW_RANGE
    exact: dict = {}
    out: dict = {"phase": "rgw", "card": card}
    numops_req = json.dumps({"key": "n", "value": 7}).encode()

    def count_launches():
        return {n: fn.launches for n, fn in wrappers.items()}

    async def put(s3s, key):
        """Initiate, the four parts in flight together (one connection
        each), complete."""
        st, _, body = await s3s[0].request(
            "POST", f"/{RGW_BUCKET}/{key}", {"uploads": ""})
        check(st == 200, f"initiate {key}: {st}")
        upload = ET.fromstring(body).findtext("UploadId")

        async def part(num):
            t0 = time.perf_counter()
            st, h, _ = await s3s[num - 1].request(
                "PUT", f"/{RGW_BUCKET}/{key}",
                {"partNumber": str(num), "uploadId": upload},
                memoryview(payload)[(num - 1) * OSD_PART:num * OSD_PART])
            part_s["request"].append(time.perf_counter() - t0)
            check(st == 200, f"part {num} of {key}: {st}")
            return h["etag"].strip('"')
        etags = await asyncio.gather(*(part(n)
                                       for n in range(1, n_parts + 1)))
        comp = ET.Element("CompleteMultipartUpload")
        for num, etag in enumerate(etags, 1):
            p = ET.SubElement(comp, "Part")
            ET.SubElement(p, "PartNumber").text = str(num)
            ET.SubElement(p, "ETag").text = etag
        st, _, body = await s3s[0].request(
            "POST", f"/{RGW_BUCKET}/{key}", {"uploadId": upload},
            ET.tostring(comp))
        check(st == 200, f"complete {key}: {st} {body[:200]!r}")
        return ET.fromstring(body).findtext("ETag").strip('"')

    async def get(s3, key, label):
        t0 = time.perf_counter()
        st, _h, got = await s3.request("GET", f"/{RGW_BUCKET}/{key}")
        sec = time.perf_counter() - t0
        exact[f"{label} {key}"] = st == 200 and got == payload
        return sec

    # a part's seconds: the client's request, and inside it the gateway's
    # upload_part (its stripes' RADOS writes, the MD5 ETag, the upload
    # doc); the rest is HTTP, the frontend and its SigV4 payload check
    part_s: dict = {"request": [], "gateway": []}

    # the host hashing a 16 MiB part costs on each side of the wire: the
    # client's SigV4 payload sha256, the gateway's sha256 check and MD5 ETag
    first_part = memoryview(payload)[:OSD_PART]
    hash_ms = {}
    for name in ("sha256", "md5"):
        t0 = time.perf_counter()
        hashlib.new(name, first_part).hexdigest()
        hash_ms[name] = (time.perf_counter() - t0) * 1e3

    async def drive():
        mon, osds, stores, client = await osd_cluster_start(dev)
        fe = watcher = None
        s3s: list = []
        try:
            check(all(o.device.type == "cuda" for o in osds.values()),
                  "an OSD is not on the card")
            data_id = mon.osdmap.lookup_pool("rgw.data")
            meta_id = mon.osdmap.lookup_pool("rgw.meta")
            await pool_active(mon, osds, data_id)
            await pool_active(mon, osds, meta_id)
            rgw = RGWLite(client, "rgw.data", "rgw.meta")
            upload_part = rgw.upload_part

            async def timed_upload_part(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return await upload_part(*args, **kw)
                finally:
                    part_s["gateway"].append(time.perf_counter() - t0)
            # the frontend calls the gateway's method on the instance
            rgw.upload_part = timed_upload_part
            calls = {"data": {}, "meta": {}}
            rgw.data = Recorder(rgw.data, calls["data"])
            rgw.meta = Recorder(rgw.meta, calls["meta"])
            fe = S3Frontend(rgw, {RGW_ACCESS: RGW_SECRET})
            addr = await fe.start()
            s3s = [S3Client(addr) for _ in range(n_parts)]
            everyone = dict(osds)
            # the path, its counts zeroed just before it
            for fn in wrappers.values():
                fn.launches = 0
            svc0 = {i: service_counts(o) for i, o in everyone.items()}
            st, _, _ = await s3s[0].request("PUT", f"/{RGW_BUCKET}")
            check(st == 200, f"create bucket: {st}")
            put_s, etags = [], []
            for key in keys:
                t0 = time.perf_counter()
                etags.append(await put(s3s, key))
                put_s.append(time.perf_counter() - t0)
            get_s = [await get(s3s[0], key, "get") for key in keys]
            t0 = time.perf_counter()
            st, h, got = await s3s[0].request(
                "GET", f"/{RGW_BUCKET}/{keys[0]}",
                headers={"Range": f"bytes={lo}-{lo + n_range - 1}"})
            range_s = time.perf_counter() - t0
            exact["ranged get"] = st == 206 and \
                got == payload[lo:lo + n_range] and \
                h.get("content-range") == \
                f"bytes {lo}-{lo + n_range - 1}/{OSD_PUT}"
            st, _, body = await s3s[0].request("GET", f"/{RGW_BUCKET}")
            listed = sorted((c.findtext("Key"), int(c.findtext("Size")))
                            for c in ET.fromstring(body).iter("Contents"))
            exact["listing"] = st == 200 and listed == sorted(
                (k, OSD_PUT) for k in keys)
            # a 9 MB atomic PUT (three stripes), read back, deleted
            t0 = time.perf_counter()
            st, _, _ = await s3s[0].request(
                "PUT", f"/{RGW_BUCKET}/atomic", body=atomic)
            atomic_s = time.perf_counter() - t0
            check(st == 200, f"atomic PUT: {st}")
            st, _, got = await s3s[0].request("GET",
                                              f"/{RGW_BUCKET}/atomic")
            exact["atomic get"] = st == 200 and got == atomic
            st, _, _ = await s3s[0].request("DELETE",
                                            f"/{RGW_BUCKET}/atomic")
            st2, _, _ = await s3s[0].request("GET",
                                             f"/{RGW_BUCKET}/atomic")
            exact["atomic delete"] = st == 204 and st2 == 404
            # bucket-index updates alone launch nothing
            before = count_launches()
            for i in range(RGW_INDEX_BURST):
                acl = ("public-read", "private")[i % 2]
                st, _, _ = await s3s[0].request(
                    "PUT", f"/{RGW_BUCKET}/{keys[0]}", {"acl": ""},
                    headers={"x-amz-acl": acl})
                check(st == 200, f"object acl {acl}: {st}")
            index_launches = {n: v - before[n]
                              for n, v in count_launches().items()}
            # outside HTTP: object classes on each pool, watch/notify
            mio, dio = rgw.meta, rgw.data
            cls_s = {}
            for pool, io in (("meta", mio), ("data", dio)):
                t0 = time.perf_counter()
                try:
                    got = float(await io.execute("counter", "numops", "add",
                                                 numops_req))
                except RadosError as e:
                    got = e.rc
                cls_s[f"numops_add_{pool}_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                out[f"numops_add_{pool}"] = got
            t0 = time.perf_counter()
            await dio.execute("greeting", "hello", "record_hello", b"rgw")
            cls_s["record_hello_data_ms"] = (time.perf_counter() - t0) * 1e3
            exact["greeting"] = await dio.read("greeting") == \
                b"Hello, rgw!"
            await mio.write_full("notify.obj", b"watched")
            watcher = RadosClient(client.mon_addrs, name="client.watcher",
                                  device=dev)
            await watcher.connect()
            got_notes: list = []
            cookie = await watcher.open_ioctx("rgw.meta").watch(
                "notify.obj", got_notes.append)
            t0 = time.perf_counter()
            res = await mio.notify("notify.obj", b"chip-smoke")
            notify_ms = (time.perf_counter() - t0) * 1e3
            exact["notify"] = res == {"acked": [["client.watcher",
                                                 cookie]],
                                      "missed": []} \
                and got_notes == [b"chip-smoke"]
            healthy = count_launches()
            svc_healthy = service_growth(everyone, svc0)
            snap = {"data": snapshot(stores, data_id),
                    "meta": snapshot(stores, meta_id, omap=True)}
            logs = {"data": pg_logs(mon, stores, data_id),
                    "meta": pg_logs(mon, stores, meta_id)}
            # one non-primary OSD holding data shards of the objects'
            # stripes killed and marked down; every object read again
            stripes = [o for o in calls["data"]
                       if "_multipart_" in o]
            dio = client.open_ioctx("rgw.data")
            primaries = {mon.osdmap.pg_to_acting_osds(dio.object_pg(o))[1]
                         for o in stripes}
            victim = data_shard_victims(mon.osdmap, dio, stripes, 1)[0]
            await osds.pop(victim).kill()
            rc, msg = await client.mon_command({"prefix": "osd down",
                                                "osd": victim})
            check(rc == 0, f"osd down {victim}: {msg}")
            await pool_active(mon, osds, data_id)
            await pool_active(mon, osds, meta_id)
            deg_s = [await get(s3s[0], key, "degraded get") for key in keys]
            launches = count_launches()
            svc = service_growth(everyone, svc0)
            out.update({
                "etags": etags, "victim": victim,
                "victim_primary_of_a_stripe": victim in primaries,
                "stripe_objects": len(stripes),
                "launches": launches, "launches_healthy": healthy,
                "launches_in_index_burst": index_launches,
                "encode_service": svc, "encode_service_healthy": svc_healthy,
                "hash_ms_16mib": hash_ms,
                "part_s_median_after_the_first_trial": {
                    k: statistics.median(v[n_parts:])
                    for k, v in part_s.items()},
                "seconds": {"put": put_s, "get": get_s,
                            "get_1_down": deg_s, "ranged_get": range_s,
                            "atomic_put_9mb": atomic_s},
                "ms": {**cls_s, "notify_round_trip": notify_ms}})
            return snap, logs, calls
        finally:
            for s3 in s3s:
                await s3.close()
            if watcher is not None:
                await watcher.shutdown()
            if fe is not None:
                await fe.stop()
            await osd_cluster_stop(mon, osds, client)

    async def drive_twin(logs, calls):
        mon, osds, stores, client = await osd_cluster_start("cpu")
        try:
            data_id = mon.osdmap.lookup_pool("rgw.data")
            meta_id = mon.osdmap.lookup_pool("rgw.meta")
            await pool_active(mon, osds, data_id)
            await pool_active(mon, osds, meta_id)
            for pool in ("data", "meta"):
                await replay(client.open_ioctx(f"rgw.{pool}"), calls[pool],
                             logs[pool])
            return ({"data": snapshot(stores, data_id),
                     "meta": snapshot(stores, meta_id, omap=True)},
                    {"data": pg_logs(mon, stores, data_id),
                     "meta": pg_logs(mon, stores, meta_id)})
        finally:
            await osd_cluster_stop(mon, osds, client)

    snap, logs, calls = asyncio.run(asyncio.wait_for(drive(),
                                                     RGW_PHASE_TIMEOUT))
    t0 = time.perf_counter()
    twin_snap, twin_logs = asyncio.run(asyncio.wait_for(
        drive_twin(logs, calls), RGW_PHASE_TIMEOUT))
    twin_s = time.perf_counter() - t0
    diff = {pool: sorted(k for k in set(snap[pool]) | set(twin_snap[pool])
                         if snap[pool].get(k) != twin_snap[pool].get(k))
            for pool in ("data", "meta")}
    same_as_twin = not any(diff.values()) and logs == twin_logs

    # the kernels at the path's shapes against their plain versions: a
    # service batch of two 4 MiB stripes (8 stripes of 64 KiB units each),
    # one stripe, the 9 MB object's 0.58 MiB tail (2 stripes), their
    # chunks' crcs, and a one-lost decode of one and of four stripes
    rs_mat = rs.reed_sol_van_matrix(K, M)
    one_lost = rs.decode_matrix(rs_mat, K, [1], [0] + list(range(2, K + 1)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 22)

    def rand_dev(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def err(a, b) -> int:
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max()) if d.numel() else 0

    kernel_errs = {}
    for label, (kind, mat, x) in {
            "encode (16, 8, 65536)": ("spec", rs_mat, rand_dev(16, K, 65536)),
            "encode (8, 8, 65536)": ("spec", rs_mat, rand_dev(8, K, 65536)),
            "encode (2, 8, 65536)": ("spec", rs_mat, rand_dev(2, K, 65536)),
            "decode 1 lost (8, 8, 65536)": ("gen", one_lost,
                                            rand_dev(8, K, 65536)),
            "decode 1 lost (32, 8, 65536)": ("gen", one_lost,
                                             rand_dev(32, K, 65536))}.items():
        kernel_errs[label] = err(
            getattr(gf_kernels, f"gf_matmul_{kind}")(mat, x),
            getattr(gf_kernels, f"gf_matmul_{kind}_plain")(mat, x))
    for nb in (16 * K, 16 * M, 2 * (K + M)):
        blk = rand_dev(nb, 65536)
        kernel_errs[f"crc ({nb}, 65536)"] = err(
            crc_kernels.crc32c_blocks(blk, 65536, 0).to(torch.int64)
            & 0xFFFFFFFF,
            cks.crc32c_batch(blk, 0).to(torch.int64) & 0xFFFFFFFF)
    torch.cuda.synchronize()

    launches, svc = out["launches"], out["encode_service"]
    svc_h = out["encode_service_healthy"]

    def c(key, base=None):
        return svc.get(key, 0) - (base or {}).get(key, 0)
    writes = c("encode_hinfo_batches") + c("shed_encode_hinfo")
    # the degraded GETs' decodes alone: at least one launch, at most one
    # per survivor set in each of the service's decode batches (healthy
    # GETs decode too where the hedged first k shards to answer hold a
    # parity shard)
    gen_down = launches["gf_matmul_gen"] \
        - out["launches_healthy"]["gf_matmul_gen"]
    launches_ok = {
        "spec": writes > 0 and launches["gf_matmul_spec"]
        == writes + c("encode_batches") + c("shed_encode"),
        "crc": launches["crc32c_blocks"] == 2 * writes,
        "gen": c("decode_batches") <= launches["gf_matmul_gen"]
        <= c("decode_requests") + c("shed_decode"),
        "gen_1_down": gen_down >= 1
        and c("decode_batches", svc_h) <= gen_down
        <= c("decode_requests", svc_h) + c("shed_decode", svc_h),
        "index_burst_none": not any(out["launches_in_index_burst"].values())}
    secs = out["seconds"]
    gib = OSD_PUT / (1 << 30)
    put_med = statistics.median(secs["put"][1:])
    get_med = statistics.median(secs["get"][1:])
    deg_med = statistics.median(secs["get_1_down"])
    out.update({
        "exact": exact, "same_as_cpu_twin": same_as_twin,
        "twin_differs_at": {p: [list(k) for k in v[:5]]
                            for p, v in diff.items()},
        "shard_objects": {p: len(v) for p, v in snap.items()},
        "log_entries": {p: sum(len(e) for e in v.values())
                        for p, v in logs.items()},
        "twin_seconds": twin_s,
        "kernels_vs_plain": kernel_errs, "launches_ok": launches_ok,
        "gib_per_s": {"s3_put": gib / put_med, "get": gib / get_med,
                      "get_1_down": gib / deg_med,
                      "osd_path_put_below_rgw": PHASE_RESULTS.get(
                          "osd", {}).get("put")},
        "ranged_get_ms": secs["ranged_get"] * 1e3,
        "seconds_in_phase": time.perf_counter() - phase_t0})
    print(json.dumps(out))
    check(all(exact.values()),
          f"a gateway answer differs from the written bytes: {exact}")
    check(out["numops_add_meta"] == 7.0,
          f"numops add on rgw.meta: {out['numops_add_meta']}")
    check(out["numops_add_data"] == -95,
          "numops add on rgw.data (omap on an EC pool) did not answer"
          f" EOPNOTSUPP: {out['numops_add_data']}")
    check(same_as_twin, "the card's stores or pg logs differ from the CPU"
          f" twin's: {out['twin_differs_at']}")
    check(not any(kernel_errs.values()),
          f"a kernel disagrees with its plain version: {kernel_errs}")
    check(all(launches_ok.values()),
          f"the rgw path's launches {launches} are not its encode service's"
          f" counts {svc}: {launches_ok}")
    return {"rgw": launches}


# -- phase 3m: persistence in the live cluster -----------------------------

# (a) a fresh cluster of 3i's shape on FaultStores on the card: config 5's
# 64 MiB as 16 objects of 4 MiB (four in flight, one trial), power cuts of
# three OSDs holding data shards (one while a second batch of writes is in
# flight), revives on their directories, convergence, deep scrub, bit rot;
# (b) the crash sweep on the card; (c) real processes: vstart's TPUStore OSDs
# on the card, the rados CLI, one OSD process SIGKILLed and restarted
PERSIST_POOL, PERSIST_META = "persist.data", "persist.meta"
PERSIST_PGS = 8
PERSIST_WAL_BYTES = 16 << 10    # a replicated object a victim holds
PERSIST_WAL_EDIT = 200          # its small overwrite: a deferred WAL entry
PERSIST_TIMEOUT = 300.0
SWEEP_TXNS = 24
VSTART_OSDS = 12
VSTART_BENCH_S = 2          # seconds a bench runs; two, for the time limit
VSTART_BENCH_THREADS = 16
VSTART_TENANTS = 8
VSTART_TENANT_OBJECTS = 16
VSTART_SCAN_BENCH_OBJECTS = 8   # bench objects scanned beside the 64 MiB one
# the least card memory an OSD process's CUDA context adds (a context with
# the port's kernels loaded takes several hundred MiB on an H100)
OSD_CONTEXT_MIB = 200


def card_memory_used_mib() -> float:
    """The card's memory in use, all processes (nvidia-smi)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])


def holds_the_card(pid: int) -> bool:
    """True when the process has a GPU device node (/dev/nvidiaN) open: it
    initialized CUDA on the card.  (nvidia-smi cannot map the processes of
    a PID namespace to their own pids.)"""
    import os
    import re

    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if re.fullmatch(r"/dev/nvidia\d+",
                            os.readlink(f"/proc/{pid}/fd/{fd}")):
                return True
        except OSError:
            pass
    return False


def csum_counter():
    """Count the stores' crc32c checksum calls that go to the card (8 or
    more blocks, as common/checksummer._calc_values decides), from any
    thread, without changing the store: returns (counts, restore)."""
    import threading

    from ceph_tpu_torch.common import checksummer as csum_mod

    real = csum_mod._calc_values
    lock = threading.Lock()
    counts = {"device_calls": 0}
    crcs = (csum_mod.CSUM_CRC32C, csum_mod.CSUM_CRC32C_16,
            csum_mod.CSUM_CRC32C_8)

    def counted(csum_type, blocks, block_size, init_value, device):
        if (device.type == "cuda" and csum_type in crcs
                and blocks.size // block_size >= csum_mod.MIN_DEVICE_BLOCKS
                and block_size % 4 == 0):
            with lock:
                counts["device_calls"] += 1
        return real(csum_type, blocks, block_size, init_value, device)

    csum_mod._calc_values = counted

    def restore():
        csum_mod._calc_values = real
    return counts, restore


async def wal_entries(io, osdmap, victims, prefix: str) -> list:
    """Give each victim a pending deferred-WAL entry: a small replicated
    object it holds, then a small overwrite of it (journaled in the KV
    commit, applied to the block file after it, trimmed only in batches).
    Returns the objects and their bytes."""
    out = []
    for v in victims:
        i = 0
        while v not in osdmap.pg_to_acting_osds(
                io.object_pg(f"{prefix}.{v}.{i}"))[0]:
            i += 1
        name = f"{prefix}.{v}.{i}"
        data = bytearray(np.random.default_rng(SEED + 30 + v).bytes(
            PERSIST_WAL_BYTES))
        await io.write_full(name, bytes(data))
        edit = np.random.default_rng(SEED + 31 + v).bytes(PERSIST_WAL_EDIT)
        await io.write(name, edit, 1000)
        data[1000:1000 + len(edit)] = edit
        out.append((name, bytes(data)))
    return out


def persist_powercut(torch, dev, card: str, wrappers: dict,
                     workdir: str) -> dict:
    """Phase 3m (a): power cuts in a live cluster of FaultStores on the
    card.  Returns the path's launches, its counts and its numbers."""
    import asyncio
    import os

    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.mon import MonDaemon
    from ceph_tpu_torch.os import ObjectId
    from ceph_tpu_torch.os.faultstore import FaultStore, crash_inject_enabled
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.osd.osdmap import PgId
    from ceph_tpu_torch.rados.client import RadosClient, RadosError
    from ceph_tpu_torch.rados.embedded import HINFO_ATTR, shard_collection

    n_objs, per_part = OSD_PUT // OSD_OBJECT, OSD_PART // OSD_OBJECT
    names = [f"pc.{j}" for j in range(n_objs)]
    old = np.random.default_rng(SEED + 32).bytes(OSD_PUT)
    new = np.random.default_rng(SEED + 33).bytes(OSD_PUT)

    def piece(buf, j):
        return memoryview(buf)[j * OSD_OBJECT:(j + 1) * OSD_OBJECT]
    compaction = {"calls": 0, "seconds": 0.0, "events_folded": 0}
    out: dict = {"phase": "persist_powercut", "card": card}

    def fault_store(i):
        store = FaultStore(os.path.join(workdir, f"osd.{i}"), device=dev)
        inner = store.compact_trace

        def timed_compact():
            before = len(store.crashlog.events)
            t0 = time.perf_counter()
            inner()
            compaction["seconds"] += time.perf_counter() - t0
            compaction["calls"] += 1
            compaction["events_folded"] += before - len(store.crashlog.events)
        store.compact_trace = timed_compact
        return store

    async def put_all(io, buf, acked):
        """The 64 MiB in four parts in flight, each part's four 4 MiB
        objects in order; records each object's ack (True) or error."""
        async def part(p):
            for i in range(per_part):
                j = p * per_part + i
                try:
                    await io.write_full(names[j], piece(buf, j))
                    acked[j] = True
                except RadosError:
                    acked[j] = False
        await asyncio.gather(*(part(p) for p in range(n_objs // per_part)))

    async def get_all(io):
        async def part(p):
            return [await io.read(names[p * per_part + i])
                    for i in range(per_part)]
        got = await asyncio.gather(*(part(p)
                                     for p in range(n_objs // per_part)))
        return [b for g in got for b in g]

    async def drive():
        mon = MonDaemon(OSD_OSDS, osds_per_host=OSD_OSDS_PER_HOST,
                        config=dict(OSD_MON_CONFIG))
        addr = await mon.start()
        stores, osds, fsids, everyone = {}, {}, {}, []
        client = None
        try:
            for i in range(OSD_OSDS):
                stores[i] = fault_store(i)
                stores[i].mkfs()
                stores[i].mount()
                fsids[i] = stores[i].fsid
                osds[i] = OSDDaemon(i, [addr], store=stores[i],
                                    config=dict(OSD_CONFIG), device=dev)
                await osds[i].start()
                everyone.append(osds[i])
            check(all(o.device.type == dev.type for o in osds.values())
                  and all(s.device.type == dev.type
                          for s in stores.values()),
                  "an OSD or its store is not on the card")
            client = RadosClient([addr])
            await client.connect()
            await client.create_ec_pool(PERSIST_POOL, dict(OSD_PROFILE),
                                        pg_num=PERSIST_PGS)
            await client.create_replicated_pool(PERSIST_META, size=3,
                                                pg_num=PERSIST_PGS)
            await wait_clean(mon, osds)
            dio = client.open_ioctx(PERSIST_POOL)
            mio = client.open_ioctx(PERSIST_META)

            async def power_cut(v):
                """Kill the daemon, then cut the power under its store:
                its directory becomes the image a machine that lost
                power would leave (un-synced block writes dropped, KV
                at its last sync commit)."""
                await osds.pop(v).kill()
                t0 = time.perf_counter()
                stores.pop(v).crash_powercut()
                out.setdefault("powercut_s", []).append(
                    time.perf_counter() - t0)

            async def mark_down(v):
                rc, msg = await client.mon_command({"prefix": "osd down",
                                                    "osd": v})
                check(rc == 0, f"osd down {v}: {msg}")

            # the path, its counts zeroed just before it
            for fn in wrappers.values():
                fn.launches = 0
            svc0 = [service_counts(o) for o in everyone]
            perf0 = [dict(o.perf) for o in everyone]
            csum, restore = csum_counter()
            try:
                # 1. the first batch
                acked1: dict = {}
                t0 = time.perf_counter()
                await put_all(dio, old, acked1)
                put_s = time.perf_counter() - t0
                check(all(acked1.get(j) for j in range(n_objs)),
                      f"a write of the first batch failed: {acked1}")
                victims = data_shard_victims(mon.osdmap, dio, names, 3)
                wal = await wal_entries(mio, mon.osdmap, victims, "wal")
                # 2. the second batch (new bytes, same names) with the
                # first victim's power cut while it is in flight; the
                # mon learns of it once the batch is done, as it would
                # past the heartbeat grace (an `osd down` racing the
                # batch's sub-writes can leave an object unfound while
                # the victim is down: ROADMAP C10)
                acked2: dict = {}
                batch = asyncio.ensure_future(put_all(dio, new, acked2))
                while not acked2 and not batch.done():
                    await asyncio.sleep(0.002)
                in_flight_at_cut = n_objs - len(acked2)
                await power_cut(victims[0])
                await batch
                await mark_down(victims[0])
                state, model_ok = {}, {}
                got = await get_all(dio)
                for j in range(n_objs):
                    legal = [bytes(piece(new, j))] if acked2.get(j) else \
                        [bytes(piece(old, j)), bytes(piece(new, j))]
                    model_ok[j] = got[j] in legal
                    state[j] = got[j]
                # 3. two more power cuts; every object read with three down
                for v in victims[1:]:
                    await power_cut(v)
                    await mark_down(v)
                t0 = time.perf_counter()
                got = await get_all(dio)
                degraded_s = time.perf_counter() - t0
                exact3 = [got[j] == state[j] for j in range(n_objs)]
                # 4. revive the three on their directories
                t0 = time.perf_counter()
                revived = {}
                for v in victims:
                    store = fault_store(v)
                    store.mount()        # the deferred WAL replays here
                    stores[v] = store
                    revived[v] = {"fsid_same": store.fsid == fsids[v],
                                  "journal_replays":
                                      store.perf["journal_replays"],
                                  "replayed_bytes":
                                      store.perf["journal_replayed_bytes"]}
                    osds[v] = OSDDaemon(v, [addr], store=store,
                                        config=dict(OSD_CONFIG), device=dev)
                    await osds[v].start()
                    everyone.append(osds[v])
                await wait_clean(mon, osds)
                clean_s = time.perf_counter() - t0
                wal_ok = [await mio.read(n) == d for n, d in wal]
                # 5. convergence: every stored shard against the CPU
                # codec's encode of the object's bytes, hinfo included
                cpu_codec = create_erasure_code({**OSD_PROFILE,
                                                 "device": "cpu"})
                cpu_sinfo = ec_util.StripeInfo(K, K * 65536)
                bad_shards, shards_checked = [], 0
                for j, name in enumerate(names):
                    shards, h, _c = ec_util.encode_with_hinfo(
                        cpu_sinfo, cpu_codec, state[j], range(K + M))
                    pg = dio.object_pg(name)
                    acting, _p = mon.osdmap.pg_to_acting_osds(pg)
                    for idx, osd in enumerate(acting):
                        cid = shard_collection(pg, idx)
                        try:
                            data = stores[osd].read(cid, ObjectId(name))
                            attrs = stores[osd].getattrs(cid,
                                                         ObjectId(name))
                            ok = bytes(data) == bytes(shards[idx]) and \
                                json.loads(attrs[HINFO_ATTR]) == h.to_dict()
                        except (KeyError, IOError):
                            ok = False
                        shards_checked += 1
                        if not ok:
                            bad_shards.append([osd, cid, name])
                # 6. deep scrub of every PG on its primary
                pool = mon.osdmap.pools[mon.osdmap.lookup_pool(
                    PERSIST_POOL)]

                async def scrub(ps):
                    pg = PgId(pool.id, ps)
                    _a, primary = mon.osdmap.pg_to_acting_osds(pg)
                    prim = osds[primary]
                    return await prim.scrub_pg(
                        prim.pgs[pg], prim.osdmap.pools[pool.id])
                t0 = time.perf_counter()
                scrubs = [await scrub(ps) for ps in range(pool.pg_num)]
                scrub_s = time.perf_counter() - t0
                # 7. bit rot in one non-primary data shard
                name = names[0]
                pg = dio.object_pg(name)
                acting, primary = mon.osdmap.pg_to_acting_osds(pg)
                idx, rot_osd = next((i, o) for i, o in enumerate(acting[:K])
                                    if o != primary)
                cid = shard_collection(pg, idx)
                stores[rot_osd].inject_bitrot(cid, ObjectId(name), byte=77)
                try:
                    stores[rot_osd].read(cid, ObjectId(name))
                    rot_caught = False
                except IOError:
                    rot_caught = True
                rot_run = await scrub(pg.ps)
                shards, _h, _c = ec_util.encode_with_hinfo(
                    cpu_sinfo, cpu_codec, state[0], range(K + M))
                rot_fixed = bytes(stores[rot_osd].read(
                    cid, ObjectId(name))) == bytes(shards[idx])
                rot_read = await dio.read(name) == state[0]
                launches = {n: fn.launches for n, fn in wrappers.items()}
                device_csums = csum["device_calls"]
            finally:
                restore()
            svc: dict = {}
            perf: dict = {}
            for n_o, o in enumerate(everyone):
                for k, v in service_counts(o).items():
                    base = svc0[n_o].get(k, 0) if n_o < len(svc0) else 0
                    svc[k] = svc.get(k, 0) + v - base
                for k, v in o.perf.items():
                    if isinstance(v, (int, float)):
                        base = perf0[n_o].get(k, 0) \
                            if n_o < len(perf0) else 0
                        perf[k] = perf.get(k, 0) + v - base
            # the trace's fold, forced once on every live store
            compacted = dict(compaction)
            t0 = time.perf_counter()
            for s in stores.values():
                s.compact_trace()
            forced_s = time.perf_counter() - t0
            base_bytes = sum(len(s.base_block) for s in stores.values())
            out.update({
                "victims": victims, "crash_inject": crash_inject_enabled(),
                "in_flight_at_first_cut": in_flight_at_cut,
                "acked_in_second_batch": sum(map(bool, acked2.values())),
                "model_ok": all(model_ok.values()),
                "exact_3_down": all(exact3), "revived": revived,
                "wal_reads_exact": all(wal_ok),
                "shards_checked": shards_checked,
                "bad_shards": bad_shards[:5], "scrubs": scrubs,
                "bitrot": {"osd": rot_osd, "caught_on_read": rot_caught,
                           "scrub": rot_run, "shard_fixed": rot_fixed,
                           "read_exact": rot_read},
                "launches": launches, "encode_service": svc,
                "perf": {k: perf.get(k, 0) for k in (
                    "encode_dispatches", "decode_dispatches",
                    "recovery_installs", "recovery_bytes_repaired")},
                "store_device_csum_calls": device_csums,
                "trace_compaction": {**compacted,
                                     "forced_once_s": forced_s,
                                     "base_image_bytes": base_bytes},
                "seconds": {"put": put_s, "read_3_down": degraded_s,
                            "revive_to_clean": clean_s,
                            "deep_scrub": scrub_s}})
        finally:
            if client is not None:
                await client.shutdown()
            for o in osds.values():
                await o.stop()
            await mon.shutdown()

    t0 = time.perf_counter()
    asyncio.run(asyncio.wait_for(drive(), 2 * PERSIST_TIMEOUT))
    launches, svc = out["launches"], out["encode_service"]
    writes = svc.get("encode_hinfo_batches", 0) + \
        svc.get("shed_encode_hinfo", 0)
    crc_want = 2 * writes + out["store_device_csum_calls"]
    out["launches_ok"] = {
        # one fused encode a service batch of whole-object writes, one a
        # batch of the re-encodes (recovery, the scrub and post-write
        # repairs: concurrent ones share a batch)
        "spec": writes > 0 and launches["gf_matmul_spec"]
        == writes + svc.get("encode_batches", 0) + svc.get("shed_encode",
                                                          0),
        # a decode launch per survivor set in each decode batch of the
        # degraded reads, the rebuilds and the scrub repair
        "gen": launches["gf_matmul_gen"] >= 1
        and svc.get("decode_batches", 0) <= launches["gf_matmul_gen"]
        <= svc.get("decode_requests", 0) + svc.get("shed_decode", 0),
        # two hinfo crc launches a fused batch, and one a store checksum
        # call of 8 or more blocks (each shard write and verified read)
        "crc": launches["crc32c_blocks"] >= crc_want
        and out["store_device_csum_calls"] > 0}
    out["crc_equals_its_count"] = launches["crc32c_blocks"] == crc_want
    gib = OSD_PUT / (1 << 30)
    secs = out["seconds"]
    out.update({"gib_per_s": {"put": gib / secs["put"],
                              "read_3_down": gib / secs["read_3_down"]},
                "seconds_in_part": time.perf_counter() - t0})
    print(json.dumps(out))
    check(out["crash_inject"], "CEPH_TPU_CRASH_INJECT is not armed")
    check(out["model_ok"], "after the power cut an object reads back as"
          " neither its acked bytes nor a legal unacked state")
    check(out["exact_3_down"], "a read with three OSDs power-cut differs")
    check(all(r["fsid_same"] and r["journal_replays"] >= 1
              for r in out["revived"].values()),
          f"a revived store is not its own disk or replayed no WAL:"
          f" {out['revived']}")
    check(out["wal_reads_exact"], "a WAL-replayed object differs")
    check(not out["bad_shards"], "shards did not converge to the CPU"
          f" encode: {out['bad_shards']}")
    check(all(s["errors"] == 0 for s in out["scrubs"]),
          f"deep scrub found errors: {out['scrubs']}")
    rot = out["bitrot"]
    check(rot["caught_on_read"] and rot["scrub"]["errors"] >= 1
          and rot["scrub"]["repaired"] >= 1 and rot["shard_fixed"]
          and rot["read_exact"], f"bit rot not caught and repaired: {rot}")
    check(all(out["launches_ok"].values()),
          f"the persist path's launches {launches} are not its counts"
          f" (service {svc}, daemons {out['perf']}, store checksums"
          f" {out['store_device_csum_calls']}): {out['launches_ok']}")
    return out


def persist_sweep(torch, dev, card: str, wrappers: dict,
                  workdir: str) -> dict:
    """Phase 3m (b): CrashSweep on the card over the default workload, its
    trace against a device="cpu" sweep's, the broken stores caught."""
    import os

    from ceph_tpu_torch.os import faultstore as fs

    crc = wrappers["crc32c_blocks"]
    for fn in wrappers.values():
        fn.launches = 0
    sweep = fs.CrashSweep(os.path.join(workdir, "sweep"), device=dev)
    in_checks = {"launches": 0, "images": 0}
    inner = sweep.check_image

    def counted_check(img, cut):
        before = crc.launches
        try:
            inner(img, cut)
        finally:
            in_checks["launches"] += crc.launches - before
            in_checks["images"] += 1
    sweep.check_image = counted_check
    t0 = time.perf_counter()
    rep = sweep.run(fs.default_workload, txns=SWEEP_TXNS, seed=0)
    sweep_s = time.perf_counter() - t0
    twin = fs.CrashSweep(os.path.join(workdir, "sweep_cpu"), device="cpu")
    twin_rep = twin.run(fs.default_workload, txns=SWEEP_TXNS, seed=0)
    broken = {}
    for cls in (fs.BrokenBlockStore, fs.BrokenCommitStore):
        r = fs.CrashSweep(os.path.join(workdir, cls.__name__),
                          store_cls=cls, device=dev).run(
            txns=8, seed=1, double_crash=False)
        broken[cls.__name__] = r["violations"]
    launches = {n: fn.launches for n, fn in wrappers.items()}
    out = {"phase": "persist_sweep", "card": card,
           "report": {k: v for k, v in rep.items() if k != "violations"},
           "violations": rep["violations"][:5],
           "trace_equals_cpu_sweep": sweep.events == twin.events
           and sweep.base_block == twin.base_block,
           "report_equals_cpu_sweep": rep == twin_rep,
           "images_checked": in_checks["images"],
           "crc_launches_in_image_checks": in_checks["launches"],
           "broken_store_violations": {k: v[:2] for k, v in broken.items()},
           "launches": launches,
           "seconds": sweep_s}
    print(json.dumps(out))
    check(not rep["violations"], f"sweep violations: {rep['violations'][:3]}")
    check(out["trace_equals_cpu_sweep"] and out["report_equals_cpu_sweep"],
          "the card's sweep recorded another trace than the CPU sweep")
    check(in_checks["launches"] > 0, "no crc launch in the image checks")
    check(bool(broken["BrokenBlockStore"]),
          "the sweep passed a store without its block fsync")
    check(any("not durable" in v for v in broken["BrokenCommitStore"]),
          "the sweep passed a store without its sync commit")
    return out


async def pgs_active(client, pg_type) -> bool:
    """Every PG of every pool active on its primary, asked over the wire
    (`dump_pgs`): the clean test for OSDs in other processes."""
    m = client.osdmap
    for pool in m.pools.values():
        prims: dict = {}
        for ps in range(pool.pg_num):
            pg = pg_type(pool.id, ps)
            prims.setdefault(m.pg_to_acting_osds(pg)[1], []).append(str(pg))
        for osd, pgs in prims.items():
            if osd < 0 or not m.is_up(osd):
                return False
            rc, st = await client.osd_command(osd, {"prefix": "dump_pgs"})
            if rc != 0 or any(st.get(p, {}).get("state") != "active"
                              for p in pgs):
                return False
    return True


def persist_processes(torch, dev, card: str, workdir: str) -> dict:
    """Phase 3m (c): real processes.  vstart starts one mon and 12
    TPUStore OSD processes on the card; the rados CLI makes an EC 8+3
    pool, puts and gets config 5's 64 MiB, benches (closed loop, write
    and seq; open loop, 8 tenants), scans gf_fold with and without the
    pushdown; one OSD process holding data shards is SIGKILLed (a process
    kill: the OS keeps every write it was handed) and marked down, the get
    is exact; it restarts on its store, the cluster goes clean, the get is
    exact again; perf dumps, nvidia-smi's process list; vstart --stop."""
    import asyncio
    import concurrent.futures
    import glob
    import os
    import signal

    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.osd.osdmap import PgId
    from ceph_tpu_torch.rados.client import RadosClient

    data_dir = os.path.join(workdir, "vstart")
    libs0 = sorted(glob.glob(str(_build.BUILD_DIR / "*.so")))
    out: dict = {"phase": "persist_processes", "card": card,
                 "kill": "SIGKILL of the process (not a power cut)"}
    secs: dict = {}
    exact: dict = {}
    py = sys.executable
    mon = ""
    # the daemons' and the CLI's device: the card unless the phase is given
    # another (a CPU rehearsal)
    dev_args = [] if dev.type == "cuda" else ["--device", dev.type]
    root = os.path.dirname(os.path.abspath(__file__))

    def tool(args, env_extra=None, timeout=240):
        env = dict(os.environ)
        env.update(env_extra or {})
        t0 = time.perf_counter()
        r = subprocess.run([py, "-m", *args], capture_output=True,
                           timeout=timeout, env=env, cwd=root)
        return r, time.perf_counter() - t0

    def rados(*args, env_extra=None):
        r, s = tool(["ceph_tpu_torch.tools.rados", *dev_args, "-m", mon,
                     *args], env_extra)
        check(r.returncode == 0, f"rados {' '.join(args[:4])}: rc"
              f" {r.returncode} {r.stderr[-1500:]!r}")
        return r.stdout, s

    def get_exact(label, big, dst):
        _o, secs[label] = rados("-p", PERSIST_POOL, "get", "big", dst)
        with open(dst, "rb") as f:
            exact[label] = f.read() == big
        os.remove(dst)

    own_mib = torch.cuda.memory_reserved(dev) / (1 << 20) \
        if dev.type == "cuda" else 0.0
    mem0 = card_memory_used_mib() - own_mib if dev.type == "cuda" else 0.0
    up, secs["vstart"] = tool(["ceph_tpu_torch.tools.vstart", "--data-dir",
                               data_dir, "--mons", "1", "--osds",
                               str(VSTART_OSDS), *dev_args])
    check(up.returncode == 0, f"vstart: {up.stderr[-2000:]!r}")
    mon = up.stdout.decode().split("export CEPH_TPU_MON=")[1].split()[0]
    pids_file = os.path.join(data_dir, "vstart.pids")
    with open(pids_file) as f:
        pids = [int(p) for p in f.read().split()]
    restarted = None
    try:
        big = np.random.default_rng(SEED + 40).bytes(OSD_PUT)
        src, dst = os.path.join(data_dir, "big.in"), \
            os.path.join(data_dir, "big.out")
        with open(src, "wb") as f:
            f.write(big)
        rados("mkpool", PERSIST_POOL, "--pg-num", str(PERSIST_PGS),
              "--ec-profile", json.dumps(OSD_PROFILE))
        _o, secs["put"] = rados("-p", PERSIST_POOL, "put", "big", src)
        get_exact("get", big, dst)
        bench = {}
        for mode in ("write", "seq"):
            o, _s = rados("-p", PERSIST_POOL, "bench", str(VSTART_BENCH_S),
                          mode, "-b", str(OSD_OBJECT), "-t",
                          str(VSTART_BENCH_THREADS))
            bench[mode] = json.loads(o)
        # the open loop at half the closed-loop seq rate, over 8 tenants
        rate = 0.5 * bench["seq"]["ops_per_sec"] / VSTART_TENANTS
        o, _s = rados("-p", PERSIST_POOL, "bench", str(VSTART_BENCH_S),
                      "seq", "--tenants", str(VSTART_TENANTS),
                      "--arrival-rate", f"{rate:.3f}", "--blend",
                      "read=0.7,write=0.3", "-b", str(OSD_OBJECT),
                      "--objects", str(VSTART_TENANT_OBJECTS))
        bench["tenants"] = json.loads(o)
        out["tenant_rate_per_s"] = rate
        scan_objs = ["big"] + [f"bench_{s}_0" for s in
                               range(VSTART_SCAN_BENCH_OBJECTS)]
        # the pushdown scan and its read-then-compute twin, side by side
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            scans = [pool.submit(rados, "-p", PERSIST_POOL, "scan",
                                 "gf_fold", *scan_objs, env_extra=env)
                     for env in (None, {"CEPH_TPU_COMPUTE": "0"})]
            (o, _s), (o_rtc, _s2) = [f.result() for f in scans]
        pushdown = json.loads(o)
        exact["scan"] = pushdown["results"] == json.loads(o_rtc)["results"] \
            and not pushdown["errors"] \
            and len(pushdown["results"]) == len(scan_objs)

        async def drive():
            nonlocal restarted
            client = RadosClient(mon, device=dev)
            await client.connect()
            try:
                io = client.open_ioctx(PERSIST_POOL)
                t0 = time.perf_counter()
                res, errs = await io.compute("gf_fold", scan_objs)
                secs["scan_in_process"] = time.perf_counter() - t0
                exact["scan_in_process"] = not errs and {
                    o: bytes(v).hex() for o, v in res.items()} == \
                    pushdown["results"]
                await client.create_replicated_pool(PERSIST_META, size=3,
                                                    pg_num=PERSIST_PGS)
                victim = data_shard_victims(client.osdmap, io, ["big"],
                                            1)[0]
                mio = client.open_ioctx(PERSIST_META)
                wal = await wal_entries(mio, client.osdmap, [victim], "wal")
                os.kill(pids[1 + victim], signal.SIGKILL)
                rc, msg = await client.mon_command({"prefix": "osd down",
                                                    "osd": victim})
                check(rc == 0, f"osd down {victim}: {msg}")
                await asyncio.to_thread(get_exact, "get_1_down", big, dst)
                # the restart on its own store directory (no --device:
                # the card)
                t0 = time.perf_counter()
                restarted = subprocess.Popen(
                    [py, "-m", "ceph_tpu_torch.osd", "--id", str(victim),
                     "--mon", mon, "--store-path",
                     os.path.join(data_dir, f"osd.{victim}"), *dev_args],
                    stdout=subprocess.PIPE, cwd=root,
                    stderr=open(os.path.join(data_dir, "restart.log"), "w"))
                with open(pids_file, "a") as f:
                    f.write(f" {restarted.pid}")
                line = await asyncio.to_thread(restarted.stdout.readline)
                check(line.startswith(b"OSD_ADDR"),
                      f"the restarted OSD printed {line!r}")
                clean = False
                while not clean and \
                        time.perf_counter() - t0 < PERSIST_TIMEOUT:
                    await asyncio.sleep(0.2)
                    await client.refresh_map()
                    clean = await pgs_active(client, PgId)
                check(clean, "the cluster never went clean after the"
                      " restart")
                secs["restart_to_clean"] = time.perf_counter() - t0
                # the get and the restarted OSD's perf dump, side by side
                _g, (o, _s) = await asyncio.gather(
                    asyncio.to_thread(get_exact, "get_after_restart", big,
                                      dst),
                    asyncio.to_thread(rados, "tell", str(victim), "perf",
                                      "dump"))
                exact["wal_objects"] = all(
                    [await mio.read(n) == d for n, d in wal])
                dumps = {victim: json.loads(o)}
                for osd in range(VSTART_OSDS):
                    if osd != victim:
                        rc, dumps[osd] = await client.osd_command(
                            osd, {"prefix": "perf dump"})
                        check(rc == 0, f"perf dump osd.{osd}")
                ec_pool = client.osdmap.lookup_pool(PERSIST_POOL)
                prims = {client.osdmap.pg_to_acting_osds(
                    PgId(ec_pool, ps))[1] for ps in range(PERSIST_PGS)}
                if dev.type == "cuda":
                    out["card_memory_mib"] = {
                        "before_vstart": mem0,
                        "osds_running": card_memory_used_mib()
                        - torch.cuda.memory_reserved(dev) / (1 << 20)}
                return victim, dumps, prims
            finally:
                await client.shutdown()

        victim, dumps, prims = asyncio.run(asyncio.wait_for(
            drive(), 2 * PERSIST_TIMEOUT))
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        apps = {int(line.split(",")[0]): line.split(",")[1].strip()
                for line in smi.stdout.splitlines() if line.strip()}
        osd_pids = [p for i, p in enumerate(pids[1:1 + VSTART_OSDS])
                    if i != victim] + [restarted.pid]
        on_card = {p: holds_the_card(p) for p in osd_pids}
        mem = out.get("card_memory_mib", {})
        grew = mem.get("osds_running", 0.0) - mem.get("before_vstart", 0.0)
        hinfo_batches = {
            o: sum(p.get("batches", 0) for label, p in
                   d["encode_service"]["profiles"].items()
                   if label.startswith("encode_hinfo"))
            for o, d in dumps.items()}
        out.update({
            "mon": mon, "victim": victim, "bench": bench,
            "scan_objects": len(scan_objs),
            "primaries_encode_hinfo_batches": {
                o: hinfo_batches[o] for o in sorted(prims)},
            "restarted_store": dumps[victim].get("store", {}),
            "csum_read_failures": {o: d.get("store", {}).get(
                "csum_read_failures") for o, d in sorted(dumps.items())},
            "nvidia_smi_apps": apps, "osd_pids": osd_pids,
            "osd_pids_listed_by_nvidia_smi": all(p in apps for p in osd_pids),
            "osd_pids_holding_the_card": on_card,
            "card_memory_growth_mib": grew,
            "osd_pids_on_card": all(on_card.values())
            and grew >= OSD_CONTEXT_MIB * len(osd_pids),
            "mib_per_s": {"put": OSD_PUT / (1 << 20) / secs["put"],
                          "get": OSD_PUT / (1 << 20) / secs["get"],
                          "bench_write": bench["write"]["mib_per_sec"],
                          "bench_seq": bench["seq"]["mib_per_sec"]},
            "scan_gib_per_s_in_process": (OSD_PUT + VSTART_SCAN_BENCH_OBJECTS
                                          * OSD_OBJECT) / (1 << 30)
            / secs["scan_in_process"],
            "tenants": {k: bench["tenants"].get(k) for k in (
                "goodput_mib_s", "p50_ms", "p95_ms", "p99_ms", "completed",
                "errors", "shed", "dropped", "offered")}})
    finally:
        down, secs["stop"] = tool(["ceph_tpu_torch.tools.vstart",
                                   "--data-dir", data_dir, "--stop"])
        for pid in pids + ([restarted.pid] if restarted else []):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if restarted is not None:
            restarted.wait(30)
    libs1 = sorted(glob.glob(str(_build.BUILD_DIR / "*.so")))
    out.update({"exact": exact, "seconds": secs,
                "new_build_libraries": sorted(set(libs1) - set(libs0))})
    print(json.dumps(out))
    check(down.returncode == 0, f"vstart --stop: {down.stdout!r}")
    check(all(exact.values()), f"a CLI answer differs: {exact}")
    check(not out["new_build_libraries"], "a process built a kernel library"
          f" during the phase: {out['new_build_libraries']}")
    check(out["restarted_store"].get("journal_replays", 0) >= 1,
          f"the restarted OSD replayed no WAL: {out['restarted_store']}")
    check(all(b > 0 for b in out["primaries_encode_hinfo_batches"].values()),
          "a primary of the EC pool shows no encode-service batch:"
          f" {out['primaries_encode_hinfo_batches']}")
    check(all(v == 0 for v in out["csum_read_failures"].values()),
          f"csum read failures: {out['csum_read_failures']}")
    check(out["osd_pids_on_card"], "an OSD process holds no context on the"
          f" card: {out['osd_pids_holding_the_card']}, card memory grew"
          f" {out['card_memory_growth_mib']} MiB (nvidia-smi's processes:"
          f" {out['nvidia_smi_apps']})")
    check(out["tenants"]["errors"] == 0 and out["tenants"]["completed"] > 0,
          f"the open-loop bench failed: {out['tenants']}")
    return out


def persist_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3m (path `persist`): (a) power cuts in a live cluster, (b)
    the crash sweep on the card, (c) real processes through vstart and the
    rados CLI, all under one temporary directory.  Returns the launches of
    the paths persist ((a)) and persist_sweep ((b)); (c)'s launches run
    in other processes and are held by their perf dumps."""
    import os
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="ceph_tpu_torch_persist_")
    try:
        os.environ["CEPH_TPU_CRASH_INJECT"] = "1"
        t0 = time.perf_counter()
        a = persist_powercut(torch, dev, card, wrappers, workdir)
        t1 = time.perf_counter()
        b = persist_sweep(torch, dev, card, wrappers, workdir)
        t2 = time.perf_counter()
        persist_processes(torch, dev, card, workdir)
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"phase": "persist", "card": card, "seconds": {
        "a_powercuts": t1 - t0, "b_sweep": t2 - t1, "c_processes": t3 - t2},
        "kill_kinds": {"a": "power cut (FaultStore.crash_powercut:"
                       " un-synced writes dropped)",
                       "c": "SIGKILL of an OSD process (the OS keeps"
                       " every write it was handed)"}}))
    return {"persist": a["launches"], "persist_sweep": b["launches"]}


# phase 3n: the XOR-schedule kernel and the bitmatrix codecs (path
# `xsched`).  BASELINE config 1's shape (1 MiB objects, k=4 m=2) for the
# jerasure bitmatrix trio at packetsize 2048; the MSR repair programs at
# phase 3j's shapes; a packed batch of 512 one-stripe objects; then a
# cluster of 3i's shape carrying a liberation k=4 m=2 w=7 pool whose stripe
# unit is one chunk (w x packetsize = 14,336 bytes), so that one-stripe
# writes pack: config 5's 64 MiB as 16 objects of 4 MiB four in flight, a
# burst of 512 one-stripe writes 32 in flight, a trickle of 16 spaced ones
XSCHED_PS = 2048
XSCHED_PROFILES = {
    tech: {"plugin": "jerasure", "technique": tech, "k": "4", "m": "2",
           "w": str(w), "packetsize": str(XSCHED_PS)}
    for tech, w in (("liberation", 7), ("blaum_roth", 6), ("liber8tion", 8))}
XSCHED_K = 4
XSCHED_OBJECT = 1 << 20
XSCHED_PACKED = 512
XSCHED_BENCH_ITERATIONS = 20
XSCHED_POOL = "lib.data"
XSCHED_UNIT = 7 * XSCHED_PS
XSCHED_POOL_PROFILE = {**XSCHED_PROFILES["liberation"],
                       "crush-failure-domain": "osd",
                       "stripe_unit": str(XSCHED_UNIT)}
XSCHED_BURST, XSCHED_BURST_IN_FLIGHT = 512, 32
XSCHED_TRICKLE, XSCHED_TRICKLE_GAP_S = 16, 0.1
# the OSDs' encode-service window (CEPH_TPU_ENCODE_BATCH_WINDOW_MS, the
# reference's knob): the router calls a bucket hot below a quarter of it.
# A burst's writes reach a primary a few ms apart, each behind the op
# processing of the ones before it on the one loop, so at the default 1 ms
# every write stays cold; at 20 ms the burst packs and the trickle, 20 ms
# apart, stays inline
XSCHED_WINDOW_MS = 100.0
XSCHED_MSR = {"4/3/6": {"plugin": "ec_msr", "k": "4", "m": "3", "d": "6"},
              "5/5/9": {"plugin": "ec_msr", "k": "5", "m": "5", "d": "9"}}


def xsched_ops(prog, n_objects: int, region_bytes: int) -> int:
    """32-bit lane operations of the region entry: one a tape op and
    column (a copy or a zero fill counts too)."""
    return n_objects * prog.n_ops * -(-region_bytes // 4)


def xsched_gf_ops(prog, b: int, s: int) -> int:
    """32-bit lane operations of the GF entry, the least work the schedule
    needs: one 32-bit XOR a tape op for every 32 bytes of a column (a bit
    plane of 32 bytes is one word); the bytes in and out once are the
    bytes bound's."""
    return b * -(-s // 32) * prog.n_ops


def xsched_kernels(torch, dev, card: str) -> dict:
    """Phase 3n (a): each entry of the xor_sched kernel against its plain
    version (outside any counted path), timed alone and back to back
    beside its bound and its plain version; gf_matmul_gen at the same
    repair shapes."""
    from ceph_tpu_torch.ec import xsched
    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.models import bitmatrix as bmx
    from ceph_tpu_torch.ops import gf, gf_kernels, xor_kernels
    from ceph_tpu_torch.tools.kernel_shapes import (alone_ms,
                                                    back_to_back_ms,
                                                    queued_ms)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    regions = {}
    for tech, prof in XSCHED_PROFILES.items():
        codec = create_erasure_code({**prof, "device": str(dev)})
        w = codec.w
        rb = codec.get_chunk_size(XSCHED_OBJECT) // w
        have = tuple(range(2, XSCHED_K + 2))
        for label, rows, sig in (
                ("encode", codec.bitmatrix, codec._sig),
                ("decode 0 1", bmx.decode_bitmatrix(
                    codec.bitmatrix, XSCHED_K, w, have, (0, 1)),
                 f"{codec._sig}/d{have}/(0, 1)")):
            prog = xsched.lower_program(xsched.compile_matrix(rows, sig=sig))
            regions[f"{tech} {label}"] = (prog, rand(1, prog.n_regions, rb))
        if tech == "liberation":
            prog = regions["liberation encode"][0]
            regions["one-stripe arena"] = (
                prog, rand(1, prog.n_regions, XSCHED_PS))
            regions["packed 512 one-stripe objects"] = (
                prog, rand(XSCHED_PACKED, prog.n_regions, XSCHED_PS))
    out = {"regions": {}, "gf": {}}
    worst = 0
    for name, (prog, arena) in regions.items():
        plain = arena.clone()
        xor_kernels.xor_sched_regions_plain(prog, plain)
        xor_kernels.xor_sched_regions(prog, arena)
        torch.cuda.synchronize()
        base = prog.out_base
        e = err(arena[:, base:], plain[:, base:])
        kept = bool(torch.equal(arena[:, :prog.n_in], plain[:, :prog.n_in]))
        n_obj, _r, rb = arena.shape
        b_ms, by = bound(n_obj * (prog.n_in + prog.n_out) * rb,
                         xsched_ops(prog, n_obj, rb))
        worst = max(worst, e)
        out["regions"][name] = {
            "shape": list(arena.shape), "n_in": prog.n_in,
            "n_slots": prog.n_slots, "n_out": prog.n_out,
            "n_ops": prog.n_ops, "max_abs_err": e, "inputs_kept": kept,
            "ms": alone_ms(lambda: xor_kernels.xor_sched_regions(prog,
                                                                 arena)),
            "back_to_back_ms": back_to_back_ms(
                lambda: xor_kernels.xor_sched_regions(prog, arena)),
            "queued_ms": queued_ms(
                lambda: xor_kernels.xor_sched_regions(prog, arena)),
            "plain_ms": alone_ms(lambda: xor_kernels.xor_sched_regions_plain(
                prog, plain), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": by}
        check(e == 0 and kept, f"xor_sched_regions disagrees with its plain"
              f" version on {name}")
    msr = {name: create_erasure_code({**prof, "device": str(dev)})
           for name, prof in XSCHED_MSR.items()}
    m436 = msr["4/3/6"]
    alpha = m436.get_sub_chunk_count()
    frag = m436.get_chunk_size(OSD_OBJECT) // alpha // 4 * 4
    m559 = msr["5/5/9"]
    frag559 = m559.get_chunk_size(OSD_OBJECT) // 5 // 4 * 4
    gf_cases = {
        "msr 4/3/6 rebuild lost 0 (1, 6, chunk/3)": (
            m436.repair_matrix(0, tuple(range(1, 7))), rand(1, 6, frag)),
        "msr 4/3/6 rebuild lost 6 (1, 6, 4 chunks/3)": (
            m436.repair_matrix(6, tuple(range(6))), rand(1, 6, 4 * frag)),
        "msr 5/5/9 project lost 9 (1, 5, chunk/5)": (
            m559.repair_vector(9)[None, :], rand(1, 5, frag559))}
    for name, (mat, data) in gf_cases.items():
        sched = xsched.compile_matrix(gf.gf_matrix_to_bits(mat))
        check(xsched.prefer_schedule(sched), f"{name}: the pick refuses"
              " the schedule")
        prog = xsched.lower_program(sched)
        got = xor_kernels.xor_sched_gf(prog, data)
        e = max(err(got, xor_kernels.xor_sched_gf_plain(prog, data)),
                err(got, gf_kernels.gf_matmul_gen_plain(mat, data)))
        out_t = torch.empty_like(got)
        b, _k, s = data.shape
        b_ms, by = bound(data.numel() + got.numel(),
                         xsched_gf_ops(prog, b, s))
        worst = max(worst, e)
        out["gf"][name] = {
            "matrix": list(mat.shape), "shape": list(data.shape),
            "xors_naive": sched.xors_naive,
            "xors_scheduled": sched.xors_scheduled, "n_ops": prog.n_ops,
            "n_regions": prog.n_regions, "max_abs_err": e,
            "ms": alone_ms(lambda: xor_kernels.xor_sched_gf(prog, data,
                                                            out=out_t)),
            "back_to_back_ms": back_to_back_ms(
                lambda: xor_kernels.xor_sched_gf(prog, data, out=out_t)),
            "queued_ms": queued_ms(
                lambda: xor_kernels.xor_sched_gf(prog, data, out=out_t)),
            "plain_ms": alone_ms(lambda: xor_kernels.xor_sched_gf_plain(
                prog, data), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": by,
            "gf_matmul_gen_ms": alone_ms(lambda: gf_kernels.gf_matmul_gen(
                mat, data, out=out_t)),
            "gf_matmul_gen_back_to_back_ms": back_to_back_ms(
                lambda: gf_kernels.gf_matmul_gen(mat, data, out=out_t)),
            "gf_matmul_gen_queued_ms": queued_ms(
                lambda: gf_kernels.gf_matmul_gen(mat, data, out=out_t))}
        check(e == 0, f"xor_sched_gf disagrees with its plain version and"
              f" gf_matmul_gen on {name}")
    out["max_abs_err"] = worst
    print(json.dumps({"phase": "xsched_kernels", "card": card, **out}))
    return out


def xsched_codecs(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3n (b): the trio at config 1's shape through the codec (every
    chunk against a device="cpu" twin, every two-erasure decode) and
    through the port's erasure_code_benchmark CLI; encode and decode
    GiB/s on the host clock."""
    import contextlib
    import io
    import itertools
    import random

    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.ops import xor_kernels
    from ceph_tpu_torch.tools import erasure_code_benchmark

    rng = np.random.default_rng(SEED + 22)
    gib = XSCHED_OBJECT / (1 << 30)
    out = {}
    for tech, prof in XSCHED_PROFILES.items():
        codec = create_erasure_code({**prof, "device": str(dev)})
        twin = create_erasure_code({**prof, "device": "cpu"})
        check(codec.device.type == "cuda", f"{tech}: the codec is not on"
              " the card")
        n = codec.get_chunk_count()
        obj = rng.bytes(XSCHED_OBJECT)
        before = xor_kernels.xor_sched_regions.launches
        enc = codec.encode(range(n), obj)
        enc_launches = xor_kernels.xor_sched_regions.launches - before
        want = twin.encode(range(n), obj)
        same = all(bytes(enc[i]) == bytes(want[i]) for i in range(n))
        size = len(enc[0])
        decodes = bad = 0
        for lost in itertools.combinations(range(n), 2):
            have = {i: bytes(enc[i]) for i in range(n) if i not in lost}
            got = codec.decode(set(lost), have, size)
            decodes += 1
            bad += any(bytes(got[i]) != bytes(want[i]) for i in lost)
        have01 = {i: bytes(enc[i]) for i in range(2, n)}
        before = xor_kernels.xor_sched_regions.launches
        codec.decode({0, 1}, have01, size)
        dec_launches = xor_kernels.xor_sched_regions.launches - before
        enc_s = host_median_s(torch, lambda: codec.encode(range(n), obj))
        dec_s = host_median_s(torch, lambda: codec.decode({0, 1}, have01,
                                                          size))
        bench = {}
        for workload in ("encode", "decode"):
            argv = ["-p", prof["plugin"], "-s", str(XSCHED_OBJECT), "-i",
                    str(XSCHED_BENCH_ITERATIONS), "-w", workload]
            for key, val in prof.items():
                if key != "plugin":
                    argv += ["-P", f"{key}={val}"]
            if workload == "decode":
                argv += ["-e", "2"]
            random.seed(SEED)
            buf, errs = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(errs):
                rc = erasure_code_benchmark.run(argv, device=dev)
            sec, kib = buf.getvalue().strip().splitlines()[-1].split("\t")
            bench[workload] = {"rc": rc, "seconds": float(sec),
                               "kib": int(kib),
                               "gib_per_s": int(kib) / (1 << 20)
                               / float(sec),
                               "stderr": errs.getvalue().strip()
                               .splitlines()[-1]}
        row = {"technique": tech, "w": codec.w, "chunk": size,
               "same_as_cpu_twin": same, "two_erasure_decodes": decodes,
               "bad_decodes": bad, "launches_per_encode": enc_launches,
               "launches_per_decode": dec_launches,
               "encode_gib_per_s": gib / enc_s,
               "decode_2_lost_gib_per_s": gib / dec_s, "benchmark": bench}
        out[tech] = row
        check(same, f"{tech}: chunks differ from the CPU twin's")
        check(bad == 0, f"{tech}: a two-erasure decode differs")
        check(enc_launches == dec_launches == 1, f"{tech}: an encode or a"
              " decode did not take one xor_sched launch")
        check(all(b["rc"] == 0 for b in bench.values()),
              f"{tech}: erasure_code_benchmark failed")
    print(json.dumps({"phase": "xsched_codecs", "card": card, **out}))
    return out


def xsched_cluster(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3n (c): a fresh cluster of 3i's shape with the liberation
    pool, its counts zeroed once the pool is active: the PUT, the burst
    and the trickle, every object read healthy and with two OSDs holding
    data shards killed and down, the two revived, clean.  Every stored
    shard and hinfo against a device="cpu" codec replaying the writes
    (encode_with_hinfo of each object)."""
    import asyncio

    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.mon import MonDaemon
    from ceph_tpu_torch.os.memstore import MemStore
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.rados.client import RadosClient
    from ceph_tpu_torch.rados.embedded import HINFO_ATTR

    rng = np.random.default_rng(SEED + 23)
    put = {f"put.part{p}.{i}": rng.bytes(OSD_OBJECT)
           for p in range(OSD_PUT // OSD_PART)
           for i in range(OSD_PART // OSD_OBJECT)}
    width = XSCHED_K * XSCHED_UNIT
    burst = {f"burst.{i}": rng.bytes(width) for i in range(XSCHED_BURST)}
    trickle = {f"trickle.{i}": rng.bytes(width)
               for i in range(XSCHED_TRICKLE)}
    objs = {**put, **burst, **trickle}

    async def drive():
        mon = MonDaemon(OSD_OSDS, osds_per_host=OSD_OSDS_PER_HOST,
                        config=dict(OSD_MON_CONFIG))
        addr = await mon.start()
        osds, stores = {}, {}
        for i in range(OSD_OSDS):
            stores[i] = MemStore()
            stores[i].mkfs()
            stores[i].mount()
            osds[i] = OSDDaemon(i, [addr], store=stores[i],
                                config=dict(OSD_CONFIG), device=dev)
            await osds[i].start()
        daemons = list(osds.values())
        client = RadosClient([addr])
        await client.connect()
        res: dict = {"seconds": {}}
        try:
            await client.create_ec_pool(XSCHED_POOL,
                                        dict(XSCHED_POOL_PROFILE), pg_num=8)
            pool_id = mon.osdmap.lookup_pool(XSCHED_POOL)
            await pool_active(mon, osds, pool_id)
            io = client.open_ioctx(XSCHED_POOL)
            base = {id(o): service_counts(o) for o in daemons}

            def growth():
                out: dict = {}
                for o in daemons:
                    was = base.get(id(o), {})
                    for k, v in service_counts(o).items():
                        if isinstance(v, int):
                            out[k] = out.get(k, 0) + v - was.get(k, 0)
                return out

            def hist():
                out: dict = {}
                for o in daemons:
                    for label, prof in o.encode_service.stats()[
                            "profiles"].items():
                        if label.startswith("encode_hinfo"):
                            for size, c in prof["batch_size_hist"].items():
                                out[size] = out.get(size, 0) + c
                return out

            for fn in wrappers.values():
                fn.launches = 0
            names = list(put)
            per = OSD_PART // OSD_OBJECT

            async def part(p):
                for name in names[p * per:(p + 1) * per]:
                    await io.write_full(name, put[name])
            t0 = time.perf_counter()
            await asyncio.gather(*(part(p)
                                   for p in range(OSD_PUT // OSD_PART)))
            res["seconds"]["put"] = time.perf_counter() - t0
            svc_put = growth()
            sem = asyncio.Semaphore(XSCHED_BURST_IN_FLIGHT)

            async def one(name):
                async with sem:
                    await io.write_full(name, burst[name])
            t0 = time.perf_counter()
            await asyncio.gather(*(one(name) for name in burst))
            res["seconds"]["burst"] = time.perf_counter() - t0
            svc_burst = growth()
            res["hist_after_burst"] = hist()
            t0 = time.perf_counter()
            for name, data in trickle.items():
                await io.write_full(name, data)
                await asyncio.sleep(XSCHED_TRICKLE_GAP_S)
            res["seconds"]["trickle"] = time.perf_counter() - t0
            svc_writes = growth()
            res["launches_writes"] = {n: fn.launches
                                      for n, fn in wrappers.items()}

            async def read_put():
                async def rpart(p):
                    return [(n, await io.read(n))
                            for n in names[p * per:(p + 1) * per]]
                got = await asyncio.gather(
                    *(rpart(p) for p in range(OSD_PUT // OSD_PART)))
                return [put[n] == b for g in got for n, b in g]
            t0 = time.perf_counter()
            healthy = await read_put()
            res["seconds"]["read_healthy"] = time.perf_counter() - t0
            healthy += [await io.read(n) == d for n, d in
                        {**burst, **trickle}.items()]
            res["launches_healthy_reads"] = {
                n: fn.launches - res["launches_writes"][n]
                for n, fn in wrappers.items()}
            # two OSDs holding data shards (primaries of none first)
            acting = [mon.osdmap.pg_to_acting_osds(io.object_pg(n))
                      for n in names]
            primaries = {p for _a, p in acting}
            holders: dict = {}
            for a, _p in acting:
                for osd in a[:XSCHED_K]:
                    holders[osd] = holders.get(osd, 0) + 1
            victims = sorted(holders, key=lambda o: (
                o in primaries, -holders[o], o))[:2]
            for v in victims:
                await osds.pop(v).kill()
                rc, msg = await client.mon_command({"prefix": "osd down",
                                                    "osd": v})
                check(rc == 0, f"osd down {v}: {msg}")
            t0 = time.perf_counter()
            degraded = await read_put()
            res["seconds"]["read_2_down"] = time.perf_counter() - t0
            degraded += [await io.read(n) == d for n, d in burst.items()]
            t0 = time.perf_counter()
            for v in victims:
                osds[v] = OSDDaemon(v, [addr], store=stores[v],
                                    config=dict(OSD_CONFIG), device=dev)
                await osds[v].start()
                daemons.append(osds[v])
            await wait_clean(mon, osds)
            res["seconds"]["revive_to_clean"] = time.perf_counter() - t0
            res["launches"] = {n: fn.launches for n, fn in wrappers.items()}
            res.update(victims=victims, healthy=healthy, degraded=degraded,
                       svc={"put": svc_put, "burst": svc_burst,
                            "writes": svc_writes, "all": growth()},
                       hist=hist(), snap=snapshot(stores, pool_id))
        finally:
            await client.shutdown()
            for osd in osds.values():
                await osd.stop()
            await mon.shutdown()
        return res

    import os

    was = os.environ.get("CEPH_TPU_ENCODE_BATCH_WINDOW_MS")
    os.environ["CEPH_TPU_ENCODE_BATCH_WINDOW_MS"] = str(XSCHED_WINDOW_MS)
    try:
        res = asyncio.run(asyncio.wait_for(drive(), OSD_PHASE_TIMEOUT))
    finally:
        if was is None:
            os.environ.pop("CEPH_TPU_ENCODE_BATCH_WINDOW_MS", None)
        else:
            os.environ["CEPH_TPU_ENCODE_BATCH_WINDOW_MS"] = was
    # the device="cpu" twin: every object's encode_with_hinfo on the CPU
    cpu = create_erasure_code({**XSCHED_POOL_PROFILE, "device": "cpu"})
    sinfo = ec_util.StripeInfo(XSCHED_K, width)
    want, bad, checked = {}, [], 0
    for (osd_id, cid, name), (data, attrs) in res["snap"].items():
        shard = int(cid.rsplit("s", 1)[1].split("_")[0])
        if name not in want:
            obj = objs[name] + bytes(-len(objs[name]) % width)
            shards, h, _c = ec_util.encode_with_hinfo(sinfo, cpu, obj,
                                                      range(XSCHED_K + 2))
            want[name] = ({i: bytes(v) for i, v in shards.items()},
                          h.to_dict())
        exp, hinfo = want[name]
        if bytes(data) != exp[shard] or json.loads(attrs[HINFO_ATTR]) \
                != hinfo:
            bad.append([osd_id, cid, name])
        checked += 1
    svc = res["svc"]
    put_b = svc["put"].get("encode_hinfo_batches", 0)
    burst_b = svc["burst"].get("encode_hinfo_batches", 0) - put_b
    burst_batched = svc["burst"]["batched"] - svc["put"]["batched"]
    trickle_cold = svc["writes"]["inline_cold"] - svc["burst"]["inline_cold"]
    trickle_batched = svc["writes"]["batched"] - svc["burst"]["batched"]
    lw = res["launches_writes"]
    hinfo_b = svc["writes"].get("encode_hinfo_batches", 0)
    inline = (svc["writes"]["inline"] + svc["writes"]["shed"])
    stripes_max = -(-OSD_OBJECT // width)
    gib = OSD_PUT / (1 << 30)
    secs = res["seconds"]
    out = {
        "phase": "xsched_cluster", "card": card, "seconds": secs,
        "put_gib_per_s": gib / secs["put"],
        "read_healthy_gib_per_s": gib / secs["read_healthy"],
        "read_2_down_gib_per_s": gib / secs["read_2_down"],
        "seconds_to_clean": secs["revive_to_clean"],
        "burst_writes_per_s": XSCHED_BURST / secs["burst"],
        "packed_batch_sizes": res["hist"],
        "packed_batch_sizes_after_burst": res["hist_after_burst"],
        "inline_cold": svc["writes"]["inline_cold"],
        "inline": svc["writes"]["inline"], "batched": svc["writes"]["batched"],
        "packed_batches": hinfo_b, "burst_batches": burst_b,
        "burst_batched": burst_batched, "trickle_inline_cold": trickle_cold,
        "trickle_batched": trickle_batched, "victims": res["victims"],
        "reads_exact": sum(res["healthy"]) + sum(res["degraded"]),
        "reads": len(res["healthy"]) + len(res["degraded"]),
        "shards_vs_cpu_encode_checked": checked,
        "shards_vs_cpu_encode_bad": bad[:5],
        "launches_writes": lw,
        "launches_healthy_reads": res["launches_healthy_reads"],
        "launches": res["launches"], "service": svc["all"]}
    print(json.dumps(out))
    check(all(res["healthy"]) and all(res["degraded"]), "a read of the"
          " liberation pool differs from the written bytes")
    check(not bad and checked >= len(objs) * (XSCHED_K + 2), "a stored"
          " shard or hinfo differs from the CPU twin's encode")
    check(burst_batched >= XSCHED_BURST // 4 and burst_b >= 1
          and max(int(s) for s in res["hist_after_burst"]) > 1,
          "the router did not pack the burst into multi-object batches")
    check(trickle_cold >= XSCHED_TRICKLE - 1 and trickle_batched <= 1,
          "the spaced trickle did not stay inline")
    check(lw["crc32c_blocks"] == 2 * hinfo_b, "crc32c_blocks did not"
          " launch twice per packed batch")
    check(hinfo_b <= lw["xor_sched_regions"]
          <= hinfo_b + inline * stripes_max,
          "xor_sched_regions launches do not match the packed batches and"
          " the inline encodes")
    check(lw["gf_matmul_spec"] == lw["gf_matmul_gen"] == 0,
          "a GF matmul kernel launched on the liberation pool's writes")
    check(res["launches"]["xor_sched_regions"] > lw["xor_sched_regions"],
          "the degraded reads did not decode on xor_sched")
    return {"launches": res["launches"], "summary": out}


def xsched_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3n: (a) the xor_sched kernel's entries against their plain
    versions and timed, (b) the bitmatrix trio through the codec and the
    benchmark CLI (path `xsched_codec`), (c) the liberation pool in a live
    cluster (path `xsched`).  Returns (a)'s numbers and the paths'
    launches."""
    t0 = time.perf_counter()
    kernels = xsched_kernels(torch, dev, card)
    t1 = time.perf_counter()
    for fn in wrappers.values():
        fn.launches = 0
    xsched_codecs(torch, dev, card, wrappers)
    codec_launches = {n: fn.launches for n, fn in wrappers.items()}
    t2 = time.perf_counter()
    cluster = xsched_cluster(torch, dev, card, wrappers)
    t3 = time.perf_counter()
    print(json.dumps({"phase": "xsched", "card": card, "seconds": {
        "a_kernels": t1 - t0, "b_codecs": t2 - t1, "c_cluster": t3 - t2},
        "launches": {"xsched_codec": codec_launches,
                     "xsched": cluster["launches"]}}))
    return {"kernels": kernels,
            "launches": {"xsched_codec": codec_launches,
                         "xsched": cluster["launches"]}}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a"
             " CUDA card")
    try:
        from ceph_tpu_torch.device import to_device
        from ceph_tpu_torch.ec import plan
        from ceph_tpu_torch.ec.registry import create_erasure_code
        from ceph_tpu_torch.models import reed_solomon as rs
        from ceph_tpu_torch.ops import (_build, bloom_kernels, crc_kernels,
                                        crush_kernels, fold_kernels,
                                        gf_kernels, score_kernels,
                                        xor_kernels)
        from ceph_tpu_torch.ops import checksum as cks
        from ceph_tpu_torch.ops.gf import gf_matmul_ref
        from ceph_tpu_torch.osd import ec_util
        from ceph_tpu_torch.tools.kernel_shapes import alone_ms, card_name
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")

    try:
        card = card_name()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")
    print(card)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    run_t0 = time.perf_counter()
    phase_seconds: dict = {}
    last_mark = [run_t0]

    def mark(phase: str) -> None:
        """The command's seconds so far, at the end of a phase; the
        phase's own wall seconds go on the phase_seconds line."""
        now = time.perf_counter()
        phase_seconds[phase] = now - last_mark[0]
        last_mark[0] = now
        print(json.dumps({"phase_done": phase,
                          "command_seconds": now - run_t0}))

    # -- 1. build ------------------------------------------------------------
    _build.load()
    regs, regs_by_source, spills = [], {}, 0
    for name, log in _build.build_logs().items():
        used = [int(line.split("Used")[1].split()[0])
                for line in log.splitlines()
                if "Used" in line and "registers" in line]
        regs += used
        regs_by_source[name] = max(used) if used else None
        spills += sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                      for line in log.splitlines() if "spill stores" in line)
    print(json.dumps({"phase": "build", "seconds": _build.build_seconds,
                      "max_registers_by_source": regs_by_source,
                      "kernels_compiled": len(regs),
                      "max_registers": max(regs) if regs else None,
                      "spill_store_bytes": spills,
                      "crc32c_dynamic_smem_bytes": crc_kernels.smem_bytes()}))
    for source in ("compress_score", "xor_sched"):
        print(json.dumps({"phase": "build_ptxas", "source": source,
                          "lines": [line.strip() for line in
                                    _build.build_logs().get(
                                        source, "").splitlines()
                                    if "registers" in line or "spill" in line
                                    or "smem" in line]}))
    mark("1")

    wrappers = {"gf_matmul_spec": gf_kernels.gf_matmul_spec,
                "gf_matmul_gen": gf_kernels.gf_matmul_gen,
                "crc32c_blocks": crc_kernels.crc32c_blocks,
                "crush_do_rule_batch": crush_kernels.crush_do_rule_batch,
                "score_blocks": score_kernels.score_blocks_packed,
                "gf_fold": fold_kernels.gf_fold,
                "bloom_positions": bloom_kernels.bloom_positions,
                "bloom_seal": bloom_kernels.bloom_seal,
                "xor_sched_regions": xor_kernels.xor_sched_regions,
                "xor_sched_gf": xor_kernels.xor_sched_gf}
    if sys.argv[1:] == ["--phase", "compute"]:
        # phase 3g alone, after the build: no result line
        state = compute_phase(torch, dev, card, wrappers)
        print(json.dumps({"phase_only": "compute", **{
            key: state[key] for key in ("launches", "bloom", "seal")}}))
        return
    if sys.argv[1:] == ["--phase", "xsched"]:
        # phase 3n alone, after the build: no result line
        print(json.dumps({"phase_only": "xsched", "launches": xsched_phase(
            torch, dev, card, wrappers)["launches"]}))
        return
    if sys.argv[1:] == ["--phase", "osd"]:
        # phases 3i, 3j and 3k alone, after the build: no result line
        print(json.dumps({"phase_only": "osd", "launches": osd_phase(
            torch, dev, card, wrappers)}))
        return
    if sys.argv[1:] == ["--phase", "rgw"]:
        # phase 3l alone, after the build: no result line
        print(json.dumps({"phase_only": "rgw", "launches": rgw_phase(
            torch, dev, card, wrappers)}))
        return
    if sys.argv[1:] == ["--phase", "persist"]:
        # phase 3m alone, after the build: no result line
        print(json.dumps({"phase_only": "persist", "launches": persist_phase(
            torch, dev, card, wrappers)}))
        return

    # -- 2. kernels against their plain versions ----------------------------
    rs_mat = rs.reed_sol_van_matrix(K, M)
    gf_kernels.register_matrix(rs_mat)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    data = torch.randint(0, 256, (B, K, CHUNK), dtype=torch.uint8,
                         device=dev, generator=gen)
    blocks = torch.randint(0, 256, (B * (K + M), CHUNK), dtype=torch.uint8,
                           device=dev, generator=gen)
    blocks_4k = blocks.view(-1, 4096)
    odd_len = 2052                       # no multiple of 128 or of 16
    blocks_odd = blocks.view(-1)[:4096 * odd_len].view(-1, odd_len)

    def err(a, b) -> int:
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max()) if d.numel() else 0

    def u32(t):
        return t.to(torch.int64) & 0xFFFFFFFF

    zero_mat = rs_mat.copy()
    zero_mat[1] = 0
    zero_mat[:, 5] = 0
    wide_mat = np.random.default_rng(SEED).integers(
        0, 256, (gf_kernels.MAX_R, gf_kernels.MAX_K)).astype(np.uint8)
    n_odd = 16384                        # stripes of odd_len-byte chunks
    spec_cases = {
        "rs8+3": (rs_mat, data),
        "rs10+4": (rs.reed_sol_van_matrix(10, 4),
                   blocks[:B * 10].view(B, 10, CHUNK)),
        "rs8+3 S=2052": (rs_mat, blocks.view(-1)[:n_odd * K * odd_len]
                         .view(n_odd, K, odd_len)),
        "16x64": (wide_mat, blocks.view(-1)[:4 * 64 * (64 << 10)]
                  .view(4, 64, 64 << 10)),
        # chunks that fill no whole block of 512 uint4 columns: at 4096
        # bytes no thread has a second uint4, at 12304 some have one
        "rs8+3 S=4096": (rs_mat, blocks.view(-1)[:2048 * K * 4096]
                         .view(2048, K, 4096)),
        "rs8+3 S=12304": (rs_mat, blocks.view(-1)[:1024 * K * 12304]
                          .view(1024, K, 12304)),
        "zero row and column": (zero_mat, data)}
    spec_errs = {name: err(gf_kernels.gf_matmul_spec(mat, d),
                           gf_kernels.gf_matmul_spec_plain(mat, d))
                 for name, (mat, d) in spec_cases.items()}
    spec_err = max(spec_errs.values())
    def decode_rows(lost):
        return rs.decode_matrix(rs_mat, K, list(lost), [
            i for i in range(K + M) if i not in lost][:K])

    singles = [decode_rows((e,)) for e in range(K + M)]
    triple = decode_rows((0, 4, 9))
    zero_dec = triple.copy()
    zero_dec[1] = 0
    zero_dec[:, 5] = 0
    # the generic kernel derives its schedule from the matrix on every
    # launch: the kernel's limits, the column tails and the single-word
    # path (as for spec), a zero row and column, and every decode matrix
    # of one and two erasures and a triple on the main path's stripes
    gen_cases = {
        "16x64": spec_cases["16x64"],
        **{name: (triple, spec_cases["rs8+3 " + name][1])
           for name in ("S=2052", "S=4096", "S=12304")},
        # the shortest row a 256-thread block takes (257 uint4)
        "S=4112": (triple, blocks.view(-1)[:2048 * K * 4112]
                   .view(2048, K, 4112)),
        "zero row and column": (zero_dec, data),
        **{f"lost {e}": (mat, data) for e, mat in enumerate(singles)},
        **{f"lost {a} {b}": (decode_rows((a, b)), data)
           for a in range(K + M) for b in range(a + 1, K + M)},
        "lost 0 4 9": (triple, data)}
    gen_errs = {name: err(gf_kernels.gf_matmul_gen(mat, d),
                          gf_kernels.gf_matmul_gen_plain(mat, d))
                for name, (mat, d) in gen_cases.items()}
    gen_err = max(gen_errs.values())
    crc_err = 0
    for blk, length, init in ((blocks, CHUNK, 0), (blocks, CHUNK, 0xFFFFFFFF),
                              (blocks_4k, 4096, 0),
                              (blocks_odd, odd_len, 0xFFFFFFFF)):
        crc_err = max(crc_err, err(
            u32(crc_kernels.crc32c_blocks(blk, length, init)),
            u32(cks.crc32c_batch(blk, init))))
    sync()
    print(json.dumps({"phase": "kernels_vs_plain", "gf_matmul_spec": spec_err,
                      "gf_matmul_gen": gen_err, "crc32c_blocks": crc_err,
                      "spec_shapes": {name: [list(d.shape), e] for (name, (
                          _, d)), e in zip(spec_cases.items(),
                                           spec_errs.values())},
                      "gen_shapes": {name: [list(d.shape), mat.shape[0],
                                            gen_errs[name]]
                                     for name, (mat, d) in gen_cases.items()
                                     if not name.startswith("lost")},
                      "gen_decode_matrices": sum(
                          name.startswith("lost") for name in gen_cases),
                      "crc_shapes": [[B * (K + M), CHUNK],
                                     [blocks_4k.shape[0], 4096],
                                     [blocks_odd.shape[0], odd_len]]}))
    check(spec_err == gen_err == crc_err == 0,
          "a kernel disagrees with its plain version")
    mark("2")

    # -- 3. the main path ---------------------------------------------------
    codec = create_erasure_code({"plugin": "ec_torch",
                                 "technique": "reed_sol_van",
                                 "k": str(K), "m": str(M)})
    check(codec.use_tpu and codec.device.type == "cuda",
          "the codec is not on the card")
    sinfo = ec_util.StripeInfo(K, STRIPE)
    obj = np.random.default_rng(SEED).bytes(B * STRIPE)
    obj_arr = np.frombuffer(obj, dtype=np.uint8)
    n = K + M
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    shards, hinfo, data_crc = ec_util.encode_with_hinfo(
        sinfo, codec, obj, range(n), logical_len=len(obj))
    decoded_ok = []
    for e in range(K):
        out = ec_util.decode(sinfo, codec,
                             {i: shards[i] for i in range(n) if i != e})
        decoded_ok.append(np.array_equal(np.frombuffer(out, np.uint8),
                                         obj_arr))
    full = np.stack([np.frombuffer(shards[i], np.uint8).reshape(B, CHUNK)
                     for i in range(n)], axis=1)       # (B, n, CHUNK)
    batch_ok = []
    for e in range(n):
        have = tuple(i for i in range(n) if i != e)[:K]
        got = codec.decode_batch(have, (e,),
                                 np.ascontiguousarray(full[:, have, :]))
        batch_ok.append(np.array_equal(got[:, 0, :], full[:, e, :]))
    sync()
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    stripes = obj_arr.reshape(B, K, CHUNK)
    sample = (0, B // 2, B - 1)
    parity_ok = all(np.array_equal(full[s, K:], gf_matmul_ref(rs_mat,
                                                              stripes[s]))
                    and np.array_equal(full[s, :K], stripes[s])
                    for s in sample)
    host_ok = all(hinfo.cumulative_shard_hashes[i]
                  == cks.crc32c(0xFFFFFFFF, shards[i]) for i in (0, K, n - 1))
    dev_full = torch.from_numpy(np.ascontiguousarray(
        full.transpose(1, 0, 2))).to(dev).view(n * B, CHUNK)
    crc0 = cks.crc32c_batch(dev_full, 0).cpu().numpy().view(np.uint32)
    plain_ok = (ec_util.fold_ledger(crc0.reshape(n, B).T, CHUNK)
                == hinfo.cumulative_shard_hashes)
    del dev_full
    result = {"phase": "main_path", "object_bytes": len(obj),
              "stripes": B, "chunk": CHUNK, "seconds": main_s,
              "decodes_ok": sum(decoded_ok), "decode_batch_ok": sum(batch_ok),
              "parity_vs_oracle_ok": parity_ok, "hinfo_vs_host_crc_ok": host_ok,
              "hinfo_vs_plain_crc_ok": plain_ok,
              "hinfo_total_chunk_size": hinfo.total_chunk_size,
              "data_crc": data_crc, "launches": launches}
    print(json.dumps(result))
    check(all(decoded_ok), "a decoded object differs from the original")
    check(all(batch_ok), "a decode_batch chunk differs from the original")
    check(parity_ok, "parity differs from the numpy oracle")
    check(host_ok and plain_ok, "a hinfo ledger differs from the reference")
    check(hinfo.total_chunk_size == B * CHUNK, "wrong hinfo chunk size")
    check(all(launches[name] > 0 for name in ("gf_matmul_spec",
                                              "gf_matmul_gen",
                                              "crc32c_blocks")),
          f"a kernel of the main path never launched: {launches}")

    mark("3")

    # -- 3b. CRUSH placement ------------------------------------------------
    crush_state = crush_phase(torch, dev, card)
    mark("3b")

    # -- 3c. live PG placement: OSDMapMapping and osdmaptool ----------------
    osdmap_state = osdmap_phase(torch, dev, card)
    mark("3c")

    # -- 3d. the embedded cluster -------------------------------------------
    cluster_launches = cluster_phase(torch, dev, card, wrappers)
    mark("3d")

    # -- 3e. the erasure-code plugin family ---------------------------------
    codecs_launches = codecs_phase(torch, dev, card, wrappers)
    mark("3e")

    # -- 3f. the persistent store -------------------------------------------
    store_state = store_phase(torch, dev, card, wrappers)
    mark("3f")

    # -- 3g. coded compute, coded inference and the read tier ---------------
    compute_state = compute_phase(torch, dev, card, wrappers)
    mark("3g")

    # -- 3h. the monitors and a map subscriber ------------------------------
    mon_state = mon_phase(torch, dev, card, wrappers)
    mark("3h")

    # -- 3i. the OSD daemons and the RADOS client ----------------------------
    osd_launches = osd_phase(torch, dev, card, wrappers)   # and 3j, 3k
    mark("3i-3k")

    # -- 3l. config 5 through the S3 gateway --------------------------------
    rgw_launches = rgw_phase(torch, dev, card, wrappers)
    mark("3l")

    # -- 3m. persistence in the live cluster --------------------------------
    persist_launches = persist_phase(torch, dev, card, wrappers)
    mark("3m")

    # -- 3n. the XOR-schedule kernel and the bitmatrix codecs ----------------
    xsched_state = xsched_phase(torch, dev, card, wrappers)
    mark("3n")
    # each path's launches, its counts zeroed just before it
    by_path = {"codec": launches,
               "crushtool": {"crush_do_rule_batch": crush_state["launches"]},
               "osdmap": {"crush_do_rule_batch": osdmap_state["launches"]},
               "cluster": cluster_launches, "codecs": codecs_launches,
               "store": store_state["store"],
               "store_cluster": store_state["store_cluster"],
               "compute": compute_state["launches"],
               "mon": mon_state["launches"], **osd_launches,
               **rgw_launches, **persist_launches,
               **xsched_state["launches"]}

    # -- 4. times -----------------------------------------------------------
    parity_out = torch.empty((B, M, CHUNK), dtype=torch.uint8, device=dev)
    one = singles[0]
    one_out = torch.empty((B, 1, CHUNK), dtype=torch.uint8, device=dev)
    crc_out = torch.empty(blocks.shape[0], dtype=torch.int32, device=dev)
    words = B * CHUNK // 4                       # 32-bit words per input row
    rows = []

    def path_launches(name):
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        return {"launches": sum(counts.values()),
                "launches_by_path": counts}

    def row(name, route, source, replaces, fn, plain, n_bytes, ops):
        ms = alone_ms(fn)
        plain_ms = alone_ms(plain, reps=5, warmup=1)
        b_ms, by = bound(n_bytes, ops)
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, **path_launches(name),
                "max_abs_err": {"gf_matmul_spec": spec_err,
                                "gf_matmul_gen": gen_err,
                                "crc32c_blocks": crc_err}[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": None}

    rows.append(row(
        "gf_matmul_spec", "cuda", "ceph_tpu_torch/csrc/gf_matmul.cu",
        "ceph_tpu/ops/gf_pallas.py:137",
        lambda: gf_kernels.gf_matmul_spec(rs_mat, data, out=parity_out),
        lambda: gf_kernels.gf_matmul_spec_plain(rs_mat, data),
        B * (K + M) * CHUNK, words * spec_ops_per_word(gf_kernels, rs_mat)))
    rows.append(row(
        "gf_matmul_gen", "cuda", "ceph_tpu_torch/csrc/gf_matmul.cu",
        "ceph_tpu/ops/gf_pallas.py:158",
        lambda: gf_kernels.gf_matmul_gen(one, data, out=one_out),
        lambda: gf_kernels.gf_matmul_gen_plain(one, data),
        B * (K + 1) * CHUNK, words * spec_ops_per_word(gf_kernels, one)))
    n_blk = blocks.shape[0]
    rows.append(row(
        "crc32c_blocks", "cuda", "ceph_tpu_torch/csrc/crc32c.cu",
        "ceph_tpu/ops/crc_pallas.py:111",
        lambda: crc_kernels.crc32c_blocks(blocks, CHUNK, 0, out=crc_out),
        lambda: cks.crc32c_batch(blocks, 0),
        n_blk * CHUNK + 4 * n_blk, n_blk * CHUNK // 4 * CRC_OPS_PER_WORD))

    # other shapes the main path and its users give the kernels
    triple_ms = alone_ms(
        lambda: gf_kernels.gf_matmul_gen(triple, data))
    extra = [{"name": "gf_matmul_gen", "erasures": 3, "ms": triple_ms,
              "bound_ms": bound(B * (K + 3) * CHUNK, words
                                * spec_ops_per_word(gf_kernels, triple))[0]}]
    # gf_matmul_gen on the encode matrix: spec's work, with the schedule
    # derived by the C entry on the launch
    extra.append({
        "name": "gf_matmul_gen", "matrix": "rs8+3 generator",
        "ms": alone_ms(lambda: gf_kernels.gf_matmul_gen(
            rs_mat, data, out=parity_out)),
        "bound_ms": bound(B * (K + M) * CHUNK, words
                          * spec_ops_per_word(gf_kernels, rs_mat))[0]})
    # the crc launches of plan.encode_with_crc (data chunks, then parity
    # chunks) and BlueStore-style 4 KiB block checksums
    for blk, length in ((blocks[:B * K], CHUNK), (blocks[B * K:], CHUNK),
                        (blocks_4k, 4096)):
        nb = blk.shape[0]
        nb_out = torch.empty(nb, dtype=torch.int32, device=dev)
        extra.append({
            "name": "crc32c_blocks", "blocks": nb, "length": length,
            "ms": alone_ms(lambda: crc_kernels.crc32c_blocks(
                blk, length, 0, out=nb_out)),
            "bound_ms": bound(nb * (length + 4),
                              nb * length // 4 * CRC_OPS_PER_WORD)[0]})
    # the cluster path's shapes (phase 3d): ec_util.encode hands a 64 MiB
    # object's shard streams over as one (1, 8, 8 MiB) batch, and a read or
    # repair that lost data shards decodes (2048, 8, 4096) stripes
    stream = CLUSTER_OBJECT // K
    n_stripes = stream // 4096
    cluster_shapes = (
        ("gf_matmul_spec", rs_mat, blocks.view(-1)[:K * stream]
         .view(1, K, stream)),
        ("gf_matmul_gen", singles[0], blocks.view(-1)[:K * stream]
         .view(n_stripes, K, 4096)),
        ("gf_matmul_gen", triple, blocks.view(-1)[:K * stream]
         .view(n_stripes, K, 4096)))
    for name, mat, d in cluster_shapes:
        fn = getattr(gf_kernels, name)
        plain = getattr(gf_kernels, name + "_plain")
        r = mat.shape[0]
        out_t = torch.empty((d.shape[0], r, d.shape[2]), dtype=torch.uint8,
                            device=dev)
        e = err(fn(mat, d, out=out_t), plain(mat, d))
        n_words = d.shape[0] * d.shape[2] // 4
        b_ms, by = bound(d.numel() + out_t.numel(),
                         n_words * spec_ops_per_word(gf_kernels, mat))
        extra.append({"name": name, "path": "cluster",
                      "shape": list(d.shape), "rows": r, "max_abs_err": e,
                      "ms": alone_ms(lambda: fn(mat, d, out=out_t)),
                      "plain_ms": alone_ms(lambda: plain(mat, d), reps=5,
                                           warmup=1),
                      "bound_ms": b_ms, "bound_by": by})
        check(e == 0, f"{name} disagrees with its plain version at"
              f" {list(d.shape)}")
    for sh in osdmap_state["shapes"]:
        extra.append({"name": "crush_do_rule_batch", "path": "osdmap",
                      "bound_by": "operations", **sh})
    print(json.dumps({"extra_shapes": extra, "card": card}))

    survivors = np.ascontiguousarray(full[:, 1:K + 1, :])
    gib = len(obj) / (1 << 30)
    e2e = {
        "encode_batch_s": host_median_s(
            torch, lambda: codec.encode_batch(stripes)),
        "decode_batch_s": host_median_s(
            torch, lambda: codec.decode_batch(tuple(range(1, K + 1)), (0,),
                                              survivors)),
        "encode_with_hinfo_s": host_median_s(
            torch, lambda: ec_util.encode_with_hinfo(sinfo, codec, obj,
                                                     range(n))),
    }
    e2e.update({name[:-2] + "_gib_per_s": gib / sec
                for name, sec in list(e2e.items())})
    # where the fused encode's time goes: staging the stripes onto the
    # card, the device part of plan.encode_with_crc (kernels and the copy
    # back), and the rest of encode_with_hinfo (ledger fold, shard views)
    dev_parity = torch.empty(B * M * CHUNK, dtype=torch.uint8, device=dev)
    e2e.update({
        "stage_to_device_s": host_median_s(
            torch, lambda: to_device(stripes, dev)),
        "copy_back_parity_s": host_median_s(torch, dev_parity.cpu),
        "plan_encode_with_crc_s": host_median_s(
            torch, lambda: plan.encode_with_crc(rs_mat, stripes, dev)),
    })
    print(json.dumps({"end_to_end": e2e, "object_gib": gib, "card": card}))

    crush = crush_times(torch, dev, card, crush_state)
    rows.append({
        "name": "crush_do_rule_batch", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush.cu",
        "replaces": "ceph_tpu/crush/kernel.py:374",
        **path_launches("crush_do_rule_batch"),
        "max_abs_err": max(crush["max_abs_err"], max(
            sh["max_abs_err"] for sh in osdmap_state["shapes"])),
        "ms": crush["ms"], "plain_ms": crush["plain_ms"],
        "bound_ms": crush["bound_ms"], "bound_by": "operations",
        "library_ms": None})
    # score_blocks at the store's shape: one 64 KiB span per call; the
    # library call is torch.bincount of the offset batch (the histogram
    # part only: the kernel also computes entropy and match)
    span = store_state["score_times"]["1x65536"]
    rows.append({
        "name": "score_blocks", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/compress_score.cu",
        "replaces": "ceph_tpu/compressor/scoring.py:86",
        **path_launches("score_blocks"),
        "max_abs_err": store_state["score_err"], "ms": span["ms"],
        "plain_ms": span["plain_ms"], "bound_ms": span["bound_ms"],
        "bound_by": span["bound_by"], "library_ms": span["bincount_ms"]})
    # gf_fold at the scan's shape, all-ones rows (the gf_fold compute
    # kernel; the fingerprint's weighted rows are on the compute_times
    # line); PyTorch has no XOR reduction, so no library call
    fold = compute_state["fold_times"]["gf_fold"]
    rows.append({
        "name": "gf_fold", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_fold.cu",
        "replaces": "ceph_tpu/compute/kernels.py:62",
        **path_launches("gf_fold"),
        "max_abs_err": compute_state["fold_err"], "ms": fold["ms"],
        "plain_ms": fold["plain_ms"], "bound_ms": fold["bound_ms"],
        "bound_by": fold["bound_by"], "library_ms": None})
    # bloom_positions at the tier's geometry and 65,536 hashes; its path
    # launches are 3g's queries, a kernel exercise (no OSD path calls it);
    # no PyTorch call computes the rjenkins hash, so no library call
    bloom = compute_state["bloom"]
    rows.append({
        "name": "bloom_positions", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/hitset_bloom.cu",
        "replaces": "ceph_tpu/osd/hitset.py:70",
        **path_launches("bloom_positions"),
        "max_abs_err": bloom["max_abs_err"], "ms": bloom["ms"],
        "kernel_ms": bloom["kernel_ms"], "queued_ms": bloom["queued_ms"],
        "plain_ms": bloom["plain_ms"], "bound_ms": bloom["bound_ms"],
        "bound_by": bloom["bound_by"], "library_ms": None})
    # bloom_seal at one PG's seal of the tier (the trace's last period's
    # median set); no PyTorch call computes the rjenkins hash, so no
    # library call
    seal = compute_state["seal"]
    rows.append({
        "name": "bloom_seal", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/hitset_bloom.cu",
        "replaces": "ceph_tpu/osd/hitset.py:164",
        **path_launches("bloom_seal"),
        "max_abs_err": seal["max_abs_err"], "ms": seal["ms"],
        "kernel_ms": seal["kernel_ms"], "queued_ms": seal["queued_ms"],
        "plain_ms": seal["plain_ms"], "bound_ms": seal["bound_ms"],
        "bound_by": seal["bound_by"], "library_ms": None})
    # xor_sched at the packed batch of 512 one-stripe liberation objects
    # (the region entry; both entries' launches; the GF entry's times at
    # the MSR repair shapes are on the xsched_kernels line); no PyTorch
    # call runs an XOR program, so no library call
    packed = xsched_state["kernels"]["regions"]["packed 512 one-stripe"
                                                " objects"]
    xor_counts = {path: c.get("xor_sched_regions", 0)
                  + c.get("xor_sched_gf", 0) for path, c in by_path.items()}
    rows.append({
        "name": "xor_sched", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/xor_sched.cu",
        "replaces": "ceph_tpu/ec/plan.py:864",
        "launches": sum(xor_counts.values()), "launches_by_path": xor_counts,
        "launches_by_entry": {
            name: path_launches(name)["launches"]
            for name in ("xor_sched_regions", "xor_sched_gf")},
        "max_abs_err": xsched_state["kernels"]["max_abs_err"],
        "ms": packed["ms"], "plain_ms": packed["plain_ms"],
        "bound_ms": packed["bound_ms"], "bound_by": packed["bound_by"],
        "library_ms": None})
    mark("4")
    print(json.dumps({"phase_seconds": phase_seconds, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
