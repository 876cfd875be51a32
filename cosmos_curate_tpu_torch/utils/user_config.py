"""User configuration file: storage credentials and defaults (port of
``cosmos_curate_tpu/utils/user_config.py``).

File: ``~/.config/cosmos_curate_tpu/config.yaml`` (override with
``CURATE_CONFIG_PATH``), the same file the JAX package reads. Recognised
sections::

    s3:        {access_key_id, secret_access_key, region, endpoint_url}
    azure:     {account_name, account_key, sas_token, endpoint_url}
    gcs:       {oauth_token, project, credentials_file}
    huggingface: {token}
    weights:   {prefix}

``yaml`` is imported only when the file exists. The storage backends read
their section, then the environment (``storage/s3_rest.py`` and its
siblings give the order).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Any

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_PATH = "~/.config/cosmos_curate_tpu/config.yaml"


@functools.lru_cache(maxsize=1)
def load_user_config() -> dict[str, Any]:
    path = Path(os.environ.get("CURATE_CONFIG_PATH", DEFAULT_PATH)).expanduser()
    if not path.exists():
        return {}
    import yaml

    try:
        data = yaml.safe_load(path.read_text()) or {}
        if not isinstance(data, dict):
            raise ValueError("config root must be a mapping")
        return data
    except (OSError, ValueError, yaml.YAMLError) as e:
        logger.warning("unreadable user config %s: %s", path, e)
        return {}


def get_section(name: str) -> dict[str, Any]:
    section = load_user_config().get(name, {})
    return section if isinstance(section, dict) else {}


def s3_session_kwargs() -> dict[str, Any]:
    """boto3 session and client keyword arguments from the config (with
    none, boto3's own chain of environment and files applies)."""
    s3 = get_section("s3")
    out: dict[str, Any] = {}
    if s3.get("access_key_id"):
        out["aws_access_key_id"] = s3["access_key_id"]
    if s3.get("secret_access_key"):
        out["aws_secret_access_key"] = s3["secret_access_key"]
    if s3.get("region"):
        out["region_name"] = s3["region"]
    if s3.get("endpoint_url"):
        out["endpoint_url"] = s3["endpoint_url"]
    return out
