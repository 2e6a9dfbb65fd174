"""Command-line interface: same subcommand surface as the reference kssd.

    kssd_tpu shuffle   -k -s -l -o                 (command_shuffle.c:33-41)
    kssd_tpu dist      sketch / index / search     (command_dist_wrapper.c:41-65)
    kssd_tpu set       -u -q -s -i -c -g -P -o     (command_set.c:35-47)
    kssd_tpu reverse   -L -o -b                    (command_reverse.c:35-42)
    kssd_tpu composite -r -q -o -b -i -s -d        (command_composite.c:41-52)

Dispatch logic mirrors dist_dispatch (command_dist.c:53-192):

  dist -r <raw seqs>  -o out          sketch refs + build index into out
  dist -r <co+mco dir> -o out <qry>   search query co dir vs reference db
  dist -o out <raw seqs>              sketch queries into out
  dist -o out <co dir>                build index (stage II) into out
  dist -o out <co dir> <co dir> ...   combine query sketch dirs
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kssd_tpu",
        description="accelerator k-mer substring-space sketching (kssd-compatible)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("shuffle", help="shuffle/sampling k-mer substring space")
    p.add_argument("-k", type=int, default=8, help="half k-mer length [8]")
    p.add_argument("-s", type=int, default=5, help="half substring length [5]")
    p.add_argument("-l", type=int, default=2, help="dim-reduction level [2]")
    p.add_argument("-o", default="./default", help="output file prefix")
    p.add_argument("--seed", type=int, default=None, help="RNG seed (reproducible)")
    p.add_argument("--random-perm", action="store_true",
                   help="Fisher-Yates table like the reference (the default "
                   "is a computed Feistel permutation: identical .shuf "
                   "format, gather-free device sketching)")

    p = sub.add_parser("dist", help="sketching and distance estimation")
    p.add_argument("-k", type=int, default=8, help="half k-mer length [8]")
    p.add_argument("-p", type=int, default=0, help="threads (accepted, unused)")
    p.add_argument("-l", "--list", dest="fpath", default="", help="query list file")
    p.add_argument("-L", dest="dr", default="2", help=".shuf file or dim-reduction level [2]")
    p.add_argument("-m", dest="mmry", type=float, default=0,
                   help="max memory GB (bounds sketch groups and search "
                   "query batches; 0 = unbatched)")
    p.add_argument("--koc-out", action="store_true",
                   help="append abundance-weighted output rows when the "
                   "query sketch has .a files (the reference's "
                   "koc_dist_print_nobin format — unreachable dead code "
                   "there; see ops/stats.format_koc_pair_line)")
    p.add_argument("-n", dest="kmerocrs", type=int, default=1, help="least k-mer occurrence (fastq)")
    p.add_argument("-Q", dest="kmerqlty", type=int, default=0, help="min base quality byte")
    p.add_argument("-r", dest="refpath", default="", help="reference dir")
    p.add_argument("-o", dest="outdir", default=".", help="output dir")
    p.add_argument("-N", dest="num_neigb", type=int, default=0, help="top-N refs [0=all]")
    p.add_argument("-D", dest="mut_dist_max", type=float, default=1.0, help="max distance")
    p.add_argument("-M", dest="metric", type=int, default=0, help="0 Jaccard / 1 Containment")
    p.add_argument("-O", dest="outfields", type=int, default=2, help="0 dist / 1 +qv / 2 +CI / 3 full 4-metric table")
    p.add_argument("--correction", type=int, default=0, help="shared-count correction")
    p.add_argument("-A", dest="abundance", action="store_true", help="abundance (koc) mode")
    p.add_argument("-u", dest="dedup", action="store_true", help="drop repeated ref k-mers")
    p.add_argument("--keepcofile", action="store_true",
                   help="also write per-genome <i>.co.<c> intermediates "
                   "(the reference parses but silently ignores this flag "
                   "— command_dist.c:341 removes them unconditionally)")
    p.add_argument("-P", dest="pipecmd", default="", help="pipe command")
    p.add_argument("--keepskf", action="store_true", help="keep shared-kmer matrix")
    p.add_argument("-f", dest="skf", default="", help="shared-kmer matrix path")
    p.add_argument("--byread", action="store_true", help="sketch by read")
    p.add_argument("--component-sz", type=int, default=7, help="component space exponent [7]")
    p.add_argument("--device-index", action="store_true",
                   help="run the stage II inversion sort on the "
                        "accelerator (PCIe hosts: ~minutes -> seconds "
                        "for GTDB-scale; identical artifacts)")
    p.add_argument("--no-dense-index", action="store_true",
                   help="skip the reference-format dense mco.index "
                   "export (2 GiB at CSZ=7); our CSR sidecar is always "
                   "written and is what search loads")
    p.add_argument("--no-compat-order", action="store_true",
                   help="fast device dedup; sketch files sorted, distances unchanged")
    p.add_argument("--cpu-count", action="store_true", help="count on host, not device")
    p.add_argument("--shard", default="", metavar="I:N",
                   help="sketch only shard I of N (multi-host stage I)")
    p.add_argument("--merge-shards", action="store_true",
                   help="merge a sharded sketch root (from --shard runs) into -o")
    p.add_argument("--mesh", default="", metavar="DPxREF",
                   help="search with a sharded device mesh, e.g. 2x4")
    p.add_argument("--shard-strategy", default="genome",
                   choices=["genome", "code"],
                   help="--mesh DB sharding: 'genome' blocks (collective-"
                        "free column outputs, default) or 'code' ranges "
                        "(psum-merged partials)")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a jax profiler trace to DIR")
    p.add_argument("remaining", nargs="*", help="query files/dirs")

    p = sub.add_parser("set", help="sketch union/intersection/subtraction")
    p.add_argument("-u", dest="union", action="store_true", help="union")
    p.add_argument("-q", dest="uniq_union", action="store_true", help="uniq union")
    p.add_argument("-s", dest="subtract", default="", help="subtract pan-sketch")
    p.add_argument("-i", dest="intersect", default="", help="intersect pan-sketch")
    p.add_argument("-c", dest="combin_pan", action="store_true", help="combine pans")
    p.add_argument("-g", dest="grouping", default="", help="grouping tsv")
    p.add_argument("-P", dest="print_names", action="store_true", help="print genome names")
    p.add_argument("-p", type=int, default=1, help="threads (accepted)")
    p.add_argument("-o", dest="outdir", default="./", help="output dir")
    p.add_argument("remaining", nargs="*", help="input sketch dir(s)")

    p = sub.add_parser("reverse", help="reverse sketch to k-mer set")
    p.add_argument("-L", dest="shuf", required=True, help=".shuf file")
    p.add_argument("-o", dest="outdir", default=".", help="output dir")
    p.add_argument("-p", type=int, default=1)
    p.add_argument("-b", dest="byreads", action="store_true", help="by reads")
    p.add_argument("--component-sz", type=int, default=7)
    p.add_argument("remaining", nargs="*", help="co dir")

    sub.add_parser("primer", help=argparse.SUPPRESS)  # hidden, like the
    # reference: prints the largest prime below 2^i for i in 8..51
    # (global_wrapper.c:107-109, find_lgst_primer_2pow global_basic.c:364-388)

    p = sub.add_parser("convert", help="composite output -> Krona/QIIME/CAMI"
                       " (ports of src/*.pl, see postproc.py)")
    p.add_argument("mode", choices=[
        "krona", "qiime", "cami",
        # the nine small src/*.pl utilities (postproc.py)
        "extract-taxid", "ac2psid", "csv-subset", "ncbi-ftp",
        "kmer-finder", "species2psid", "species2ncbi", "abv-meta",
        "psid2ncbitax",
    ])
    p.add_argument("-t", dest="tax", default="",
                   help="psid->taxonomy tsv (krona) / psid->ncbi tsv (cami)")
    p.add_argument("-n", dest="nodes", default="",
                   help="taxid,rank,parent,name tsv (cami)")
    p.add_argument("-o", dest="outdir", default="./convert_out")
    p.add_argument("inputs", nargs="+",
                   help="composite report (krona/cami) or Krona tables (qiime)")

    p = sub.add_parser("composite", help="metagenomic composition analysis")
    p.add_argument("-r", dest="refdir", default="", help="reference sketch dir")
    p.add_argument("-q", dest="qrydir", default="", help="query koc sketch dir")
    p.add_argument("-o", dest="outdir", default="./", help="output dir")
    p.add_argument("-p", type=int, default=1)
    p.add_argument("-b", dest="binvec", action="store_true", help="write .abv vectors")
    p.add_argument("-i", dest="idxbv", action="store_true", help="index .abv vectors")
    p.add_argument("-s", dest="searchbv", type=int, default=-1,
                   help="abv search: 0 cosine / 1 L1 / 2 L2")
    p.add_argument("-d", dest="readabv", action="store_true", help="dump .abv file")
    p.add_argument("--device-search", action="store_true",
                   help="force the dense device .abv search / device -q join "
                   "(auto-selected for large matrices; see "
                   "composite.ABV_DENSE_THRESHOLD)")
    p.add_argument("--host-search", action="store_true",
                   help="force the reference-parity sparse host walk for "
                   "-s even at scale")
    p.add_argument("--mesh", default="", metavar="N",
                   help="shard the -q join's reference DB over N devices "
                   "(1-D ref mesh; parallel/sharded_composite.py)")
    p.add_argument("remaining", nargs="*")

    args = parser.parse_args(argv)
    return _dispatch(args)


def _dispatch(args) -> int:
    if args.command == "shuffle":
        return _cmd_shuffle(args)
    if args.command == "dist":
        return _cmd_dist(args)
    if args.command == "set":
        from public_kssd_tpu import setops

        return setops.cmd_set(args)
    if args.command == "reverse":
        from public_kssd_tpu import reverse

        return reverse.cmd_reverse(args)
    if args.command == "composite":
        from public_kssd_tpu import composite

        return composite.cmd_composite(args)
    if args.command == "convert":
        from public_kssd_tpu import postproc

        return postproc.cmd_convert(args)
    if args.command == "primer":
        from public_kssd_tpu.config import (
            DEFAULT_CTX_SPC_USE_L, LD_FCTR, largest_prime_below_pow2,
        )

        # byte-identical to the reference (find_lgst_primer_2pow's
        # diagnostics, global_basic.c:372, then the dispatch printf,
        # global_wrapper.c:109)
        for w in range(8, 52):
            n = 1 << w
            hshsz = int(float(n) * DEFAULT_CTX_SPC_USE_L / LD_FCTR)
            print(f"w={w}\tspace_sz={n}\thashsize={hshsz}"
                  f"\tkmerlimt={int(hshsz * LD_FCTR)}")
            p = largest_prime_below_pow2(w)
            print(f"nearest prime={p}")
            print(p)
        return 0
    return 2


def _cmd_shuffle(args) -> int:
    from public_kssd_tpu import formats, shufspace
    from public_kssd_tpu.config import MIN_SUBCTX_DIM_SMP_SZ, SketchParams

    if args.k < args.s:
        sys.exit("shuffle: half k-mer length must be >= half substring length")
    if args.s >= 8:
        sys.exit("shuffle: subk should be smaller than 8")
    dim_after = 1 << (4 * (args.s - args.l))
    if dim_after < MIN_SUBCTX_DIM_SMP_SZ:
        print(
            f"warning: dimension after reduction {dim_after} < suggested minimum "
            f"{MIN_SUBCTX_DIM_SMP_SZ}; -s {args.l + 3} is suggested",
            file=sys.stderr,
        )
    params = SketchParams.create(k=args.k, drlevel=args.l, subk=args.s, seed=args.seed)
    if args.random_perm:
        perm = formats.make_shuffled_dim(params, seed=args.seed)
    else:
        # computed space: header id doubles as the Feistel seed, making
        # the .shuf self-describing (shufspace.detect)
        perm = shufspace.make_feistel_dim(params)
    formats.write_shuf(args.o + ".shuf", params, perm)
    print(
        f"kssd_tpu shuffle: shuf_id={params.id}, k = {params.k}, "
        f"halfCtxLen = {params.subk}, level= {params.drlevel}"
    )
    return 0


def _is_co_dir(path: str) -> bool:
    from public_kssd_tpu import formats

    return os.path.isfile(os.path.join(path, formats.CO_DSTAT))


def _is_mco_dir(path: str) -> bool:
    from public_kssd_tpu import formats

    return os.path.isfile(os.path.join(path, formats.MCO_DSTAT))


def _load_params(args):
    """(params, shuf) where shuf is a ComputedShuf when the .shuf encodes
    a Feistel space (gather-free kernel), else the permutation table."""
    from public_kssd_tpu import formats, shufspace
    from public_kssd_tpu.config import SketchParams

    if os.path.isfile(args.dr):
        params, perm = formats.read_shuf(args.dr, component_sz=args.component_sz)
        computed = shufspace.detect(params, perm)
        return params, (computed if computed is not None else perm)
    params = SketchParams.create(
        k=args.k, drlevel=int(args.dr), component_sz=args.component_sz
    )
    perm = shufspace.make_feistel_dim(params)
    os.makedirs(args.outdir, exist_ok=True)
    shuf_path = os.path.join(args.outdir, "default.shuf")
    formats.write_shuf(shuf_path, params, perm)
    print(f"generated {shuf_path} (shuf_id={params.id})")
    return params, shufspace.ComputedShuf(params.id, params.half_subctx_len)


def _cmd_dist(args) -> int:
    from public_kssd_tpu import formats, index, infiles, pipeline, search
    from public_kssd_tpu.ops import stats as stats_ops
    from public_kssd_tpu.utils import profile_trace

    with profile_trace(args.profile or None):
        return _cmd_dist_inner(args, formats, index, infiles, pipeline,
                               search, stats_ops)


def _cmd_dist_inner(args, formats, index, infiles, pipeline, search, stats_ops) -> int:

    opts = pipeline.SketchOptions(
        abundance=args.abundance,
        min_occurrence=args.kmerocrs,
        min_qual=args.kmerqlty,
        uniq=args.dedup,
        byread=args.byread,
        pipecmd=args.pipecmd or None,
        compat_order=not args.no_compat_order,
        keepcofile=args.keepcofile,
    )
    out_opts = stats_ops.OutputOptions(
        metric=stats_ops.Metric(args.metric),
        fields=stats_ops.Fields(args.outfields),
        correction=bool(args.correction),
        max_dist=args.mut_dist_max,
        top_n=args.num_neigb,
    )

    if args.merge_shards:
        from public_kssd_tpu.parallel import distributed

        distributed.merge_shards(args.remaining[0], args.outdir)
        return 0
    if args.shard:
        from public_kssd_tpu.parallel import distributed

        shard_id, n_shards = (int(x) for x in args.shard.split(":"))
        if args.fpath:
            files = infiles.organize_infile_list(args.fpath)
        else:
            files = infiles.organize_infiles(args.remaining, fmt_ck=not args.pipecmd)
        params, perm = _load_params(args)
        distributed.sketch_shard(
            files, args.outdir, params, perm, opts, shard_id, n_shards
        )
        return 0

    # --- reference side (command_dist.c:60-107) ---
    if args.refpath:
        if not (_is_co_dir(args.refpath) or _is_mco_dir(args.refpath)):
            # raw sequences: sketch + index into outdir
            files = infiles.organize_infiles([args.refpath])
            if not files:
                sys.exit(f"no valid input files in {args.refpath}")
            params, perm = _load_params(args)
            ref_opts = pipeline.SketchOptions(**{
                **opts.__dict__, "abundance": False  # command_dist.c:94
            })
            pipeline.run_stage1(files, args.outdir, params, perm, ref_opts,
                                mem_gb=args.mmry)
            index.run_stage2(args.outdir, args.outdir, args.component_sz,
                             dense=not args.no_dense_index,
                             device=args.device_index)
            args.refpath = args.outdir
        elif _is_co_dir(args.refpath) and not _is_mco_dir(args.refpath):
            index.run_stage2(args.refpath, args.refpath, args.component_sz,
                             dense=not args.no_dense_index,
                             device=args.device_index)

    # --- query side (command_dist.c:108-190) ---
    if args.remaining or args.fpath:
        qry = args.remaining[0] if args.remaining else ""
        qry_is_co = bool(qry) and _is_co_dir(qry) and not args.pipecmd

        if args.refpath:
            if not _is_mco_dir(args.refpath):
                sys.exit("need the ref db dir (with index) for -r search mode")
            if not qry_is_co:
                sys.exit(
                    "search mode needs a sketched query dir: run "
                    "'kssd_tpu dist -L <shuf> -o <qdir> <seqs>' first"
                )
            mesh = None
            if args.mesh:
                import jax
                import numpy as np
                from jax.sharding import Mesh

                dp, ref = (int(x) for x in args.mesh.lower().split("x"))
                mesh = Mesh(
                    np.array(jax.devices()[: dp * ref]).reshape(dp, ref),
                    ("dp", "ref"),
                )
            search.search(
                args.refpath,
                qry,
                args.outdir,
                out_opts,
                use_device=not args.cpu_count,
                keep_shared_kmer=args.keepskf,
                shared_kmer_path=args.skf or None,
                mesh=mesh,
                component_sz=args.component_sz,
                mem_gb=args.mmry,
                koc=args.koc_out,
                shard_strategy=args.shard_strategy,
            )
            return 0
        if qry_is_co:
            if len(args.remaining) == 1:
                index.run_stage2(qry, args.outdir, args.component_sz,
                                 dense=not args.no_dense_index,
                             device=args.device_index)
            else:
                from public_kssd_tpu import combine

                combine.combine_queries(args.remaining, args.outdir)
            return 0
        # raw sequences -> sketch into outdir
        if args.fpath:
            files = infiles.organize_infile_list(args.fpath)
        else:
            files = infiles.organize_infiles(args.remaining, fmt_ck=not args.pipecmd)
        if not files:
            sys.exit("please specify valid query sequences")
        params, perm = _load_params(args)
        pipeline.run_stage1(files, args.outdir, params, perm, opts,
                            mem_gb=args.mmry)
        return 0
    if args.refpath and _is_mco_dir(args.refpath):
        # -r <already-indexed dir> with no query args: nothing to do —
        # say so instead of silently exiting 0 (a raw/-co refpath DID
        # sketch/index above, which is the reference's index-only use)
        print(
            f"{args.refpath} is already indexed and no query was given; "
            "nothing to do (pass a sketched query dir to search)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
