"""``cosmos-curate-tpu-torch index …``: manage the persistent corpus
embedding index (port of ``cosmos_curate_tpu/cli/index_cli.py``).

    index build  --input-path <split-root>   train centroids + shard a run's
                                             embeddings (pending in-pipeline
                                             fragments are cleared)
    index add    --input-path <split-root>   route another run into an
                                             existing index (no re-cluster)
    index query  --input-path <split-root>   dedup-query a run against the
                                             index; optional CSV in the
                                             dedup_summary format `local
                                             shard --dedup-csv` consumes
    index stats  --index-path <root>         meta + shard/pending counts
    index consolidate --index-path <root>    fold pending fragments into the
                                             index
    index compact --index-path <root>        one compaction pass

``--index-path`` defaults to ``<input>/index``, the root ``local split
--corpus-index`` writes its fragments to. Every action that opens the
index takes ``--device`` (its k-means and top-k products run there:
``cuda`` unless given ``cpu``). ``--no-mesh`` is accepted as the
reference accepts it; the port scores on one device either way (the mesh
waits for ROADMAP queue A item 7). ``index serve`` (the HTTP search
server, ``service/search.py``) is refused: it waits for item 19.
"""

from __future__ import annotations

import argparse
import json
import sys

_SERVE = "the HTTP search server service/search.py (ROADMAP queue A item 19)"


def register(sub: argparse._SubParsersAction) -> None:
    index = sub.add_parser("index", help="persistent corpus embedding index (IVF dedup queries)")
    isub = index.add_subparsers(dest="subcommand", metavar="action")

    def _device(p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "--device", default="cuda", choices=["cuda", "cpu"],
            help="where the index's products run (default: cuda; never falls back to the CPU)",
        )

    def _common(p: argparse.ArgumentParser, needs_input: bool = True) -> None:
        if needs_input:
            p.add_argument(
                "--input-path", required=True,
                help="split output root (with embeddings/<model>/)",
            )
        p.add_argument("--index-path", default="", help="index root (default: <input>/index)")
        p.add_argument("--embedding-model", default="", help='"" = first found')
        p.add_argument("--no-mesh", action="store_true")
        _device(p)

    build = isub.add_parser("build", help="train centroids and shard a run's embeddings")
    _common(build)
    build.add_argument("--k", type=int, default=0, help="clusters (0 = sqrt(N))")
    build.add_argument("--iters", type=int, default=20)
    build.set_defaults(func=_cmd_build)

    add = isub.add_parser("add", help="route a run's embeddings into an existing index")
    _common(add)
    add.set_defaults(func=_cmd_add)

    query = isub.add_parser("query", help="dedup-query a run's embeddings against the index")
    _common(query)
    query.add_argument("--eps", type=float, default=0.07)
    query.add_argument("--nprobe", type=int, default=0, help="0 = index default")
    query.add_argument("--top-k", type=int, default=8)
    query.add_argument(
        "--output-csv", default="",
        help="write a dedup_summary CSV (consumable by `local shard --dedup-csv`)",
    )
    query.set_defaults(func=_cmd_query)

    stats = isub.add_parser("stats", help="index metadata + shard/pending counts")
    stats.add_argument("--index-path", required=True)
    _device(stats)
    stats.set_defaults(func=_cmd_stats)

    consolidate = isub.add_parser(
        "consolidate",
        help="fold pending fragments into the index (trains centroids only if "
        "the index does not exist yet)",
    )
    consolidate.add_argument("--index-path", required=True)
    consolidate.add_argument("--k", type=int, default=0, help="clusters (0 = sqrt(N))")
    consolidate.add_argument("--iters", type=int, default=20)
    consolidate.add_argument("--no-mesh", action="store_true")
    _device(consolidate)
    consolidate.set_defaults(func=_cmd_consolidate)

    compact = isub.add_parser(
        "compact",
        help="one compaction pass: fold pending, rebalance skewed clusters, "
        "refresh centroids, publish a new manifest generation",
    )
    compact.add_argument("--index-path", required=True)
    compact.add_argument("--rebalance-factor", type=float, default=4.0,
                         help="split clusters larger than this × mean rows")
    compact.add_argument("--no-rebalance", action="store_true")
    compact.add_argument("--no-fold-pending", action="store_true")
    compact.add_argument("--no-refresh-centroids", action="store_true")
    compact.add_argument("--force", action="store_true",
                         help="publish a generation even when nothing changed")
    compact.add_argument(
        "--gc", action="store_true",
        help="delete fragments superseded generations reference (safe only "
        "with no live index-server readers)",
    )
    compact.add_argument("--no-mesh", action="store_true")
    _device(compact)
    compact.set_defaults(func=_cmd_compact)

    srv = isub.add_parser("serve", help="standalone HTTP search server over the index (not ported yet)")
    srv.add_argument("--index-path", required=True)
    srv.add_argument("--host", default="0.0.0.0")
    srv.add_argument("--port", type=int, default=8081)
    srv.add_argument("--text-model", default="clip-text-b-tpu",
                     help="CLIP text tower for text-to-clip queries")
    srv.add_argument("--cache-mb", type=int, default=0,
                     help="warm shard cache budget in MB (0 = env/default)")
    srv.add_argument("--no-warmup", action="store_true")
    srv.add_argument("--max-inflight", type=int, default=8)
    srv.add_argument("--max-waiting", type=int, default=32)
    srv.add_argument("--compact-interval-s", type=float, default=0.0,
                     help="background compaction cadence (0 disables)")
    srv.add_argument("--metrics-port", type=int, default=None)
    srv.set_defaults(func=_cmd_serve)

    index.set_defaults(func=lambda args: (index.print_help(), 2)[1])


def _index_root(args: argparse.Namespace) -> str:
    return (args.index_path or f"{args.input_path.rstrip('/')}/index").rstrip("/")


def _cmd_build(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex
    from cosmos_curate_tpu_torch.dedup.index_store import IndexStore
    from cosmos_curate_tpu_torch.pipelines.video.dedup import load_embeddings

    root = _index_root(args)
    ids, vecs, model = load_embeddings(args.input_path, args.embedding_model)
    index = CorpusIndex.build(root, ids, vecs, model=model, k=args.k or None, iters=args.iters, device=args.device,
                              metrics_name="index_cli")
    # Pending in-pipeline fragments at this root (a --corpus-index run that
    # skipped consolidation) hold the SAME rows the writer also wrote to the
    # embeddings parquet, which the build above ingested: consolidating
    # them too would double every clip, so they are cleared.
    cleared = IndexStore(root).clear_pending()
    print(json.dumps({**index.stats(), "pending_cleared": cleared}, indent=2))
    return 0


def _cmd_add(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex
    from cosmos_curate_tpu_torch.pipelines.video.dedup import load_embeddings

    index = CorpusIndex.open(_index_root(args), device=args.device, metrics_name="index_cli")
    ids, vecs, model = load_embeddings(args.input_path, args.embedding_model)
    if index.meta.get("model") and model != index.meta["model"]:
        print(
            f"error: run embeddings are from {model!r} but the index holds "
            f"{index.meta['model']!r} — one embedding space per index",
            file=sys.stderr,
        )
        return 2
    added = index.add(ids, vecs)
    print(json.dumps({**index.stats(), "added": added}, indent=2))
    return 0


def _cmd_query(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, incremental_dedup
    from cosmos_curate_tpu_torch.pipelines.video.dedup import load_embeddings

    root = _index_root(args)
    index = CorpusIndex.open(root, device=args.device, metrics_name="index_cli")
    ids, vecs, model = load_embeddings(args.input_path, args.embedding_model)
    result = incremental_dedup(index, ids, vecs, eps=args.eps, nprobe=args.nprobe or None, top_k=args.top_k)
    if args.output_csv:
        from cosmos_curate_tpu_torch.storage.writers import write_csv

        rows = [
            {"clip_uuid": cid, "action": "removed", "duplicate_of": result["duplicate_of"].get(cid, "")}
            for cid in result["removed"]
        ] + [{"clip_uuid": cid, "action": "kept", "duplicate_of": ""} for cid in result["kept"]]
        write_csv(args.output_csv, rows, ["clip_uuid", "action", "duplicate_of"])
    print(
        json.dumps(
            {
                "index_path": root,
                "embedding_model": model,
                "eps": args.eps,
                "num_queries": len(ids),
                "num_kept": len(result["kept"]),
                "num_removed": len(result["removed"]),
                "duplicate_of": result["duplicate_of"],
                "output_csv": args.output_csv,
            },
            indent=2,
        )
    )
    return 0


def _cmd_consolidate(args: argparse.Namespace) -> int:
    """Fold pending fragments against the existing centroids, or train
    centroids from them when the index is new, without re-reading the
    run's embeddings parquet."""
    from cosmos_curate_tpu_torch.dedup.corpus_index import consolidate_index

    root = args.index_path.rstrip("/")
    result = consolidate_index(root, k=args.k or None, iters=args.iters, device=args.device,
                               metrics_name="index_cli")
    print(json.dumps({"index_path": root, **result}, indent=2))
    return 0


def _cmd_compact(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.dedup.compaction import compact_index

    report = compact_index(
        args.index_path.rstrip("/"),
        device=args.device,
        fold_pending=not args.no_fold_pending,
        rebalance=not args.no_rebalance,
        rebalance_factor=args.rebalance_factor,
        refresh_centroids=not args.no_refresh_centroids,
        force=args.force,
        gc=args.gc,
    )
    print(json.dumps(report, indent=2))
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    raise NotImplementedError(f"index serve runs {_SERVE}, not ported yet")


def _cmd_stats(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex
    from cosmos_curate_tpu_torch.dedup.index_store import IndexStore

    root = args.index_path.rstrip("/")
    store = IndexStore(root)
    if not store.exists():
        pending = len(store.list_pending())
        print(
            json.dumps(
                {
                    "index_path": root,
                    "exists": False,
                    "pending_fragments": pending,
                    "hint": "run `index build` (or a --corpus-index split) first",
                },
                indent=2,
            )
        )
        return 0 if pending else 2
    print(json.dumps(CorpusIndex.open(root, device=args.device).stats(), indent=2))
    return 0
