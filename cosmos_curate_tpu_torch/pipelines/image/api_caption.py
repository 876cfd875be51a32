"""API-backed image captioning via OpenAI-compatible chat endpoints (port of
``cosmos_curate_tpu/pipelines/image/api_caption.py``).

One stage speaking the OpenAI chat-completions dialect covers any
compatible server (hosted APIs, vLLM / llama.cpp serving, a gateway). The
request body carries the raw file bytes as a ``data:<media>;base64,`` URL,
byte for byte the reference's. stdlib urllib only; a thread pool of
``concurrency`` workers; per-image retry with the shared backoff
(``storage/retry.py``) on 429 and the transient 5xx, on a dropped
connection and on a malformed 200; a failure lands in the task's
``errors["api_caption"]`` and never fails the run. Host work only: no
device.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.pipelines.image.annotate import ImageTask
from cosmos_curate_tpu_torch.storage.retry import is_retryable_status, sleep_backoff
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ImageApiCaptionStage(Stage[ImageTask, ImageTask]):
    def __init__(
        self,
        *,
        base_url: str,
        model: str = "default",
        api_key: str = "",
        prompt: str = "Describe this image in one detailed sentence.",
        max_tokens: int = 128,
        timeout_s: float = 60.0,
        max_retries: int = 3,
        concurrency: int = 4,
    ) -> None:
        # accept both conventions: a server root or an OpenAI-SDK-style
        # base_url already ending in /v1
        self.base_url = base_url.rstrip("/").removesuffix("/v1")
        self.model_name = model
        self.api_key = api_key
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.concurrency = max(1, concurrency)

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0)

    _MEDIA_TYPES = {
        ".png": "image/png",
        ".webp": "image/webp",
        ".bmp": "image/bmp",
        ".jpg": "image/jpeg",
        ".jpeg": "image/jpeg",
    }

    def _payload(self, task: ImageTask) -> bytes:
        suffix = "." + task.path.rsplit(".", 1)[-1].lower() if "." in task.path else ""
        media = self._MEDIA_TYPES.get(suffix, "image/jpeg")
        b64 = base64.b64encode(task.raw_bytes or b"").decode()
        return json.dumps(
            {
                "model": self.model_name,
                "max_tokens": self.max_tokens,
                "messages": [
                    {
                        "role": "user",
                        "content": [
                            {"type": "text", "text": self.prompt},
                            {"type": "image_url", "image_url": {"url": f"data:{media};base64,{b64}"}},
                        ],
                    }
                ],
            }
        ).encode()

    def _caption_one(self, task: ImageTask) -> None:
        url = f"{self.base_url}/v1/chat/completions"
        payload = self._payload(task)
        last: Exception | None = None
        for attempt in range(self.max_retries):
            req = urllib.request.Request(
                url, data=payload, method="POST", headers={"content-type": "application/json"}
            )
            if self.api_key:
                req.add_header("authorization", f"Bearer {self.api_key}")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    body = json.loads(resp.read())
                task.caption = body["choices"][0]["message"]["content"].strip()
                return
            except urllib.error.HTTPError as e:
                last = e
                if not is_retryable_status(e.code):
                    break  # 4xx won't heal on retry
            except (
                urllib.error.URLError,
                ConnectionError,
                TimeoutError,
                # malformed 200 bodies: non-JSON, empty choices, null message
                ValueError,
                KeyError,
                IndexError,
                TypeError,
                AttributeError,
            ) as e:
                last = e
            if attempt + 1 < self.max_retries:
                sleep_backoff(attempt)
        task.errors["api_caption"] = repr(last)

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        live = [t for t in tasks if t.raw_bytes is not None and not t.filtered_by]
        if not live:
            return tasks
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            list(pool.map(self._caption_one, live))
        done = sum(1 for t in live if t.caption)
        if done < len(live):
            logger.warning("api captioning: %d/%d images failed", len(live) - done, len(live))
        return tasks
