"""``cosmos-curate-tpu-torch view``: a local web viewer for curated output
(port of ``cosmos_curate_tpu/cli/view_cli.py``; the same pages).

Equivalent capability of the reference's clip viewer
(cosmos_curate/client/view_cli/clip_viewer.py:316): browse clips, captions
and scores from a split output directory in the browser.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def register(sub: argparse._SubParsersAction) -> None:
    view = sub.add_parser("view", help="browse curated clips in a browser")
    view.add_argument("--input-path", required=True, help="split output root")
    view.add_argument("--host", default="127.0.0.1")
    view.add_argument("--port", type=int, default=8081)
    view.set_defaults(func=_cmd_view)


_PAGE = """<!DOCTYPE html>
<html><head><title>cosmos-curate-tpu viewer</title>
<style>
body {{ font-family: sans-serif; margin: 2rem; background: #111; color: #eee; }}
.clip {{ display: inline-block; margin: 1rem; padding: 1rem; background: #1c1c1c;
        border-radius: 8px; vertical-align: top; width: 340px; }}
video {{ width: 320px; border-radius: 4px; }}
.meta {{ font-size: 0.8rem; color: #aaa; white-space: pre-wrap; }}
.caption {{ font-size: 0.9rem; margin-top: 0.5rem; }}
</style></head>
<body><h1>Curated clips ({count})</h1>{clips}</body></html>
"""

_CLIP = """<div class="clip">
<video controls src="/clips/{uuid}.mp4"></video>
<div class="caption">{caption}</div>
<div class="meta">span {span_start:.1f}-{span_end:.1f}s | motion {motion} | aesthetic {aesthetic}{filtered}</div>
</div>"""


def _render_index(root: Path) -> str:
    import html

    cards = []
    for meta_path in sorted((root / "metas" / "v0").glob("*.json")):
        meta = json.loads(meta_path.read_text())
        captions = [
            c for w in meta.get("windows", []) for c in (w.get("captions") or {}).values() if c
        ]
        # captions are model output over untrusted video: escape everything
        cards.append(
            _CLIP.format(
                uuid=html.escape(str(meta["uuid"])),
                caption=(html.escape(captions[0]) if captions else "<i>no caption</i>"),
                span_start=meta["span_start"],
                span_end=meta["span_end"],
                motion=_fmt(meta.get("motion_score_global")),
                aesthetic=_fmt(meta.get("aesthetic_score")),
                filtered=(
                    f" | FILTERED: {html.escape(str(meta['filtered_by']))}"
                    if meta.get("filtered_by")
                    else ""
                ),
            )
        )
    return _PAGE.format(count=len(cards), clips="\n".join(cards))


def _fmt(v) -> str:
    return f"{v:.4f}" if isinstance(v, (int, float)) else "-"


def _cmd_view(args: argparse.Namespace) -> int:
    from aiohttp import web

    root = Path(args.input_path)
    if not (root / "metas" / "v0").exists():
        print(f"error: {root} does not look like a split output (no metas/v0)")
        return 2

    async def index(request: web.Request) -> web.Response:
        return web.Response(text=_render_index(root), content_type="text/html")

    app = web.Application()
    app.router.add_get("/", index)
    app.router.add_static("/clips", str(root / "clips"))
    print(f"viewer at http://{args.host}:{args.port}/")
    web.run_app(app, host=args.host, port=args.port)
    return 0
