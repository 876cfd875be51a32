"""The three in-process fake object stores (``tests/storage/fake_*.py``),
started together, with the environment that points both packages' storage
clients at them: ``AWS_*`` for ``s3://``, ``STORAGE_EMULATOR_HOST`` for
``gs://`` (the SDK and the REST backend alike) and ``AZURE_STORAGE_*`` for
``az://``. No request leaves 127.0.0.1."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator

import pytest

from tests.storage.fake_azure import TEST_ACCOUNT, TEST_KEY, FakeAzureServer
from tests.storage.fake_gcs import FakeGcsServer
from tests.storage.fake_s3 import TEST_ACCESS_KEY, TEST_SECRET_KEY, FakeS3Server


@dataclass
class ObjectStores:
    s3: FakeS3Server
    gcs: FakeGcsServer
    azure: FakeAzureServer

    @property
    def env(self) -> dict[str, str]:
        return {
            "AWS_ACCESS_KEY_ID": TEST_ACCESS_KEY,
            "AWS_SECRET_ACCESS_KEY": TEST_SECRET_KEY,
            "AWS_DEFAULT_REGION": "us-east-1",
            "AWS_ENDPOINT_URL": self.s3.endpoint,
            "STORAGE_EMULATOR_HOST": self.gcs.endpoint,
            "AZURE_STORAGE_ACCOUNT": TEST_ACCOUNT,
            "AZURE_STORAGE_KEY": TEST_KEY,
            "AZURE_STORAGE_ENDPOINT": self.azure.endpoint,
        }

    def auth_failures(self) -> list[str]:
        return self.s3.state.auth_failures + self.azure.state.auth_failures


@contextlib.contextmanager
def running_object_stores() -> Iterator[ObjectStores]:
    with FakeS3Server() as s3, FakeGcsServer() as gcs, FakeAzureServer() as azure:
        yield ObjectStores(s3, gcs, azure)


@pytest.fixture
def object_stores(monkeypatch) -> Iterator[ObjectStores]:
    """The fakes, with the environment set for the test's duration; the test
    fails if either signing fake refused a request."""
    with running_object_stores() as stores:
        for k, v in stores.env.items():
            monkeypatch.setenv(k, v)
        yield stores
        assert not stores.auth_failures(), stores.auth_failures()
