"""osdmaptool parity CLI (port of ceph_tpu/tools/osdmaptool.py).

Reference: the reference's src/tools/osdmaptool.cc — create/inspect/
simulate OSDMaps offline: --createsimple, --print, --test-map-pg,
--test-map-pgs[-dump] (PG->OSD distribution with per-OSD counts),
--mark-up-in, --export-crush/--import-crush.  Compiled maps use the
versioned binary encoding (ceph_tpu_torch.common.encoding), the same
bytes the JAX package's tool writes, so a map file written by either tool
loads in the other.

`--test-map-pgs[-dump]` places every PG through OSDMapMapping on the CUDA
placement kernel, on the card unless `run` is given `device="cpu"` (no
CUDA and no device raises); the rest of the tool needs no device.  It
prints byte for byte what the JAX package's tool prints, except where the
JAX OSDMapMapping differs from its own host path (ROADMAP.md C3): the
port's mapping equals the host path.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

import numpy as np

from ceph_tpu_torch.osd.osdmap import (
    CEPH_OSD_EXISTS,
    CEPH_OSD_IN,
    CEPH_OSD_UP,
    OSDMap,
    OSDMapMapping,
    PgId,
    TYPE_REPLICATED,
)


def _load(path: str) -> OSDMap:
    with open(path, "rb") as f:
        return OSDMap.decode(f.read())


def _save(m: OSDMap, path: str) -> None:
    with open(path, "wb") as f:
        f.write(m.encode())


def _print_map(m: OSDMap) -> None:
    print(f"epoch {m.epoch}")
    print(f"fsid {m.fsid}")
    print(f"flags {m.flags}")
    print()
    for pool in m.pools.values():
        kind = "replicated" if pool.type == TYPE_REPLICATED else "erasure"
        print(f"pool {pool.id} '{pool.name}' {kind} size {pool.size}"
              f" min_size {pool.min_size} crush_rule {pool.crush_rule}"
              f" pg_num {pool.pg_num} pgp_num {pool.pgp_num}"
              + (f" profile {pool.erasure_code_profile}"
                 if pool.erasure_code_profile else ""))
    print()
    print(f"max_osd {m.max_osd}")
    for o in range(m.max_osd):
        if not m.exists(o):
            continue
        state = ("up" if m.is_up(o) else "down") + \
            (" in" if m.is_in(o) else " out")
        print(f"osd.{o} {state} weight {m.get_weight(o) / 0x10000:g}")


def _test_map_pgs(m: OSDMap, pool_filter: int, dump: bool,
                  device=None) -> None:
    mapping = OSDMapMapping(m, device=device)
    count = np.zeros(m.max_osd, dtype=np.int64)
    primary_count = np.zeros(m.max_osd, dtype=np.int64)
    total = 0
    sizes = {}
    for pool in m.pools.values():
        if pool_filter >= 0 and pool.id != pool_filter:
            continue
        for ps in range(pool.pg_num):
            pg = PgId(pool.id, ps)
            up, up_p, acting, acting_p = mapping.get(pg)
            if dump:
                print(f"{pg}\t{up}\t{up_p}\t{acting}\t{acting_p}")
            for o in up:
                if 0 <= o < m.max_osd:
                    count[o] += 1
            if 0 <= up_p < m.max_osd:
                primary_count[up_p] += 1
            sizes[len(up)] = sizes.get(len(up), 0) + 1
            total += 1
    print(f"pool {pool_filter if pool_filter >= 0 else 'all'}"
          f" pg_num {total}")
    print(f"size {json.dumps(sizes, sort_keys=True)}")
    in_ids = [o for o in range(m.max_osd) if m.is_in(o)]
    if in_ids:
        in_counts = count[in_ids]
        lo, hi = int(in_counts.argmin()), int(in_counts.argmax())
        print(f"min osd.{in_ids[lo]} {int(in_counts[lo])}")
        print(f"max osd.{in_ids[hi]} {int(in_counts[hi])}")
        print(f"avg {float(in_counts.mean()):.2f}"
              f" stddev {float(in_counts.std()):.2f}")


def run(argv: List[str], device=None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool")
    p.add_argument("mapfilename")
    p.add_argument("--createsimple", type=int, metavar="NUM_OSD")
    p.add_argument("--pg-bits", type=int, default=6, dest="pg_bits",
                   help="pg bits per osd for --createsimple")
    p.add_argument("--with-default-pool", action="store_true",
                   dest="with_default_pool")
    p.add_argument("--print", action="store_true", dest="print_map")
    p.add_argument("--mark-up-in", action="store_true", dest="mark_up_in")
    p.add_argument("--test-map-pg", metavar="PGID", dest="test_map_pg")
    p.add_argument("--test-map-pgs", action="store_true",
                   dest="test_map_pgs")
    p.add_argument("--test-map-pgs-dump", action="store_true",
                   dest="test_map_pgs_dump")
    p.add_argument("--pool", type=int, default=-1)
    p.add_argument("--export-crush", metavar="FILE", dest="export_crush")
    p.add_argument("--import-crush", metavar="FILE", dest="import_crush")
    args = p.parse_args(argv)

    if args.createsimple:
        m = OSDMap.build_simple(args.createsimple)
        if args.with_default_pool:
            pg_num = 1 << max(
                (args.createsimple * args.pg_bits - 1).bit_length() - 1, 3)
            m.create_pool("rbd", pg_num=min(pg_num, 1 << 15))
        _save(m, args.mapfilename)
        print(f"osdmaptool: writing epoch {m.epoch} to {args.mapfilename}")
        return 0

    try:
        m = _load(args.mapfilename)
    except OSError as e:
        print(f"osdmaptool: error reading {args.mapfilename}: {e}",
              file=sys.stderr)
        return 1

    changed = False
    if args.mark_up_in:
        for o in range(m.max_osd):
            m.osd_state[o] |= CEPH_OSD_EXISTS | CEPH_OSD_UP
            m.osd_weight[o] = CEPH_OSD_IN
        changed = True
    if args.import_crush:
        from ceph_tpu_torch.tools.crushtool import load_map

        m.crush = load_map(args.import_crush)
        changed = True
    if args.export_crush:
        from ceph_tpu_torch.crush.serialize import to_json

        with open(args.export_crush, "w") as f:
            json.dump(to_json(m.crush), f, indent=1)
        print(f"osdmaptool: exported crush map to {args.export_crush}")
    if args.test_map_pg:
        pg = PgId.parse(args.test_map_pg)
        up, up_p, acting, acting_p = m.pg_to_up_acting_osds(pg)
        print(f" parsed '{args.test_map_pg}' -> {pg}")
        print(f"{pg} raw ({up}, p{up_p}) up ({up}, p{up_p}) acting"
              f" ({acting}, p{acting_p})")
    if args.test_map_pgs or args.test_map_pgs_dump:
        _test_map_pgs(m, args.pool, args.test_map_pgs_dump, device)
    if args.print_map:
        _print_map(m)
    if changed:
        _save(m, args.mapfilename)
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
