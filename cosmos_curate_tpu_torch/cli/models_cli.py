"""``cosmos-curate-tpu-torch models``: the weights registry (port of
``cosmos_curate_tpu/cli/models_cli.py``).

- ``list``: the registered model ids and whether each has a staged
  checkpoint;
- ``stage``: copy a ``params.msgpack`` into a model's staging directory;
- ``init-random``: write a seeded random checkpoint for one of the
  reference's six ids, from the port's own seeded init (built on the CPU,
  so a seed gives the same file on every host), through
  ``registry.save_params``: the reference's format, which both packages
  load;
- ``pull-hf``: download files of a Hugging Face repo through
  ``models/hf_hub.py`` for the converters.

Exit codes are the reference's: 0, 2 on a usage error (an unknown id, a
missing file), 1 when a download fails.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path


def register(sub: argparse._SubParsersAction) -> None:
    models = sub.add_parser("models", help="model weights registry")
    msub = models.add_subparsers(dest="subcommand", metavar="action")

    ls = msub.add_parser("list", help="registered models + staging status")
    ls.set_defaults(func=_cmd_list)

    stage = msub.add_parser("stage", help="copy a params.msgpack into the registry")
    stage.add_argument("model_id")
    stage.add_argument("checkpoint", help="path to a flax msgpack checkpoint")
    stage.set_defaults(func=_cmd_stage)

    init = msub.add_parser("init-random", help="write a seeded random checkpoint")
    init.add_argument("model_id")
    init.add_argument("--seed", type=int, default=0)
    init.set_defaults(func=_cmd_init_random)

    pull = msub.add_parser(
        "pull-hf",
        help="download files from a Hugging Face repo (SDK-free, resumable) "
        "for conversion by the converters",
    )
    pull.add_argument("repo_id", help="e.g. Qwen/Qwen2-VL-2B-Instruct")
    pull.add_argument("files", nargs="+", help="repo-relative file names")
    pull.add_argument("--revision", default="main")
    pull.add_argument(
        "--dest", default="", help="destination dir (default: hf/<repo_id> under the weights root)"
    )
    pull.add_argument("--sha256", default="", help="expected sha256 (single file only)")
    pull.set_defaults(func=_cmd_pull_hf)

    models.set_defaults(func=lambda args: (models.print_help(), 2)[1])


def _cmd_list(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.models import registry

    for mid in registry.registered_models():
        ckpt = registry.local_dir_for(mid) / "params.msgpack"
        status = f"staged ({ckpt.stat().st_size >> 20} MiB)" if ckpt.exists() else "not staged"
        print(f"{mid:28s} {status}")
    print(f"\nweights root: {registry.weights_root()}")
    return 0


def _cmd_stage(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.models import registry

    if args.model_id not in registry.registered_models():
        print(f"error: unknown model id {args.model_id!r}; see `models list`")
        return 2
    src = Path(args.checkpoint)
    if not src.is_file():
        print(f"error: {src} not found")
        return 2
    dst = registry.local_dir_for(args.model_id) / "params.msgpack"
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, dst)
    print(f"staged {src} -> {dst}")
    return 0


def _cmd_pull_hf(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.models import registry
    from cosmos_curate_tpu_torch.models.hf_hub import HubDownloadError, pull_repo_files

    dest_dir = Path(args.dest) if args.dest else registry.weights_root() / "hf" / args.repo_id
    if args.sha256 and len(args.files) != 1:
        print("error: --sha256 applies to a single file")
        return 2
    try:
        for dest in pull_repo_files(
            args.repo_id,
            args.files,
            dest_dir,
            revision=args.revision,
            expected_sha256={args.files[0]: args.sha256} if args.sha256 else None,
        ):
            print(f"pulled {dest}")
    except HubDownloadError as e:
        print(f"error: {e}")
        return 1
    return 0


def _cmd_init_random(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.models import registry

    builders = init_builders()
    builder = builders.get(args.model_id)
    if builder is None:
        print(
            f"error: no random-init builder for {args.model_id!r}; "
            f"have {sorted(builders)}"
        )
        return 2
    path = registry.save_params(args.model_id, seeded(builder(), args.seed))
    print(f"wrote {path}")
    return 0


def seeded(module, seed: int):
    """``module`` filled by its own seeded init (``init_weights``) from a
    CPU generator seeded with ``seed``; never through the registry, which
    would load a staged checkpoint and ignore the seed."""
    import torch

    module.init_weights(torch.Generator().manual_seed(seed))
    return module


def init_builders() -> dict:
    """model id -> a function building the model at the reference's
    configuration for that id, on the CPU."""

    def transnet():
        from cosmos_curate_tpu_torch.models.transnetv2 import TransNet

        return TransNet()

    def clip_b16():
        from cosmos_curate_tpu_torch.models.vit import VIT_B_16, ViT

        return ViT(VIT_B_16)

    def aesthetics():
        from cosmos_curate_tpu_torch.models.clip import AestheticMLP

        # 768-d input: the default scorer composes with the L/14 tower, as
        # the published head's input width is
        return AestheticMLP(768)

    def video_embed():
        from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_BASE, VideoEmbedModel

        return VideoEmbedModel(VIDEO_EMBED_BASE)

    def caption_vlm():
        from cosmos_curate_tpu_torch.models.vlm import VLM, VLM_BASE

        return VLM(VLM_BASE)

    def t5():
        from cosmos_curate_tpu_torch.models.t5 import T5_BASE, T5Encoder

        return T5Encoder(T5_BASE)

    return {
        "transnetv2-tpu": transnet,
        "clip-vit-b16-tpu": clip_b16,
        "aesthetics-mlp-tpu": aesthetics,
        "video-embed-tpu": video_embed,
        "caption-vlm-tpu": caption_vlm,
        "t5-encoder-tpu": t5,
    }
