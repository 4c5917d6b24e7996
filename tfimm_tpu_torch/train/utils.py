"""Training utilities; mirror of tfimm_tpu/train/utils.py."""

from __future__ import annotations

import logging
import os
import re
from typing import List

__all__ = ["setup_logging", "collect_tfrecord_files"]


def setup_logging(level: str = "INFO") -> None:
    """Configure the root logger with a compact formatter."""
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper()))
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(message)s", datefmt="%H:%M:%S"))
    root.handlers = [handler]


def collect_tfrecord_files(path: str, pattern: str = r".*\.tfrecord.*") -> List[str]:
    """List record files under a local directory or an s3:// prefix
    (reference: utils.py:36-170; boto3 is an optional dependency)."""
    regex = re.compile(pattern)
    if path.startswith("s3://"):
        try:
            import boto3
        except ImportError as e:
            raise ImportError("s3:// paths require boto3") from e
        bucket_name, _, prefix = path[len("s3://"):].partition("/")
        s3 = boto3.client("s3")
        files = []
        paginator = s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=bucket_name, Prefix=prefix):
            for obj in page.get("Contents", []):
                if regex.fullmatch(os.path.basename(obj["Key"])):
                    files.append(f"s3://{bucket_name}/{obj['Key']}")
        return sorted(files)
    files = []
    for root, _, names in os.walk(path):
        files.extend(os.path.join(root, n) for n in names
                     if regex.fullmatch(n))
    return sorted(files)
