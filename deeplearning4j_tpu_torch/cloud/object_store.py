"""Object storage for dataset staging.

The port's copy of deeplearning4j_tpu/cloud/object_store.py, held against it
by tests/test_torch_streaming_cloud.py. One counterpart:
`ObjectStoreDataSetIterator` is a `datasets.iterators.DataSetIterator`, so
a container's `fit` takes it as it takes any iterator (staged to the
device ahead of each step), where the reference's `fit` refuses it; it
decodes through the port's `streaming.serde`, one object a batch. The text
below is the reference's.

TPU-native equivalent of reference deeplearning4j-aws's S3 layer
(aws/s3/reader/S3Downloader.java, uploader/S3Uploader.java,
BaseS3DataSetIterator.java): an ObjectStore SPI with
- LocalFSObjectStore: directory-backed store (test/offline backend, and the
  natural backend for NFS/persistent-disk TPU pods),
- S3ObjectStore / GCSObjectStore: import-gated real backends (boto3 /
  google-cloud-storage are not baked into this image; constructing without
  them raises with instructions),
plus ObjectStoreDataSetIterator streaming serialized DataSets straight out
of a store prefix (the BaseS3DataSetIterator role).
"""
from __future__ import annotations

import os

from ..datasets.iterators import DataSetIterator


class ObjectStore:
    def put(self, key, data: bytes):
        raise NotImplementedError

    def get(self, key) -> bytes:
        raise NotImplementedError

    def list_keys(self, prefix=""):
        raise NotImplementedError

    def delete(self, key):
        raise NotImplementedError

    # convenience file helpers (reference S3Uploader.upload / download)
    def upload_file(self, path, key):
        with open(path, "rb") as fh:
            self.put(key, fh.read())

    def download_file(self, key, path):
        data = self.get(key)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(data)


class LocalFSObjectStore(ObjectStore):
    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key):
        p = os.path.abspath(os.path.join(self.root, key))
        if not p.startswith(os.path.abspath(self.root) + os.sep):
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def put(self, key, data):
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as fh:
            fh.write(data)

    def get(self, key):
        with open(self._path(key), "rb") as fh:
            return fh.read()

    def list_keys(self, prefix=""):
        out = []
        for root, _dirs, names in os.walk(self.root):
            for n in names:
                rel = os.path.relpath(os.path.join(root, n), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, key):
        os.remove(self._path(key))


class S3ObjectStore(ObjectStore):
    """reference: aws/s3/ — boto3-backed; gated on the package."""

    def __init__(self, bucket, client=None):
        if client is None:
            try:
                import boto3
            except ImportError as e:
                raise ImportError(
                    "S3ObjectStore needs 'boto3'; install it or use "
                    "LocalFSObjectStore") from e
            client = boto3.client("s3")
        self.bucket = bucket
        self.client = client

    def put(self, key, data):
        self.client.put_object(Bucket=self.bucket, Key=key, Body=data)

    def get(self, key):
        return self.client.get_object(
            Bucket=self.bucket, Key=key)["Body"].read()

    def list_keys(self, prefix=""):
        out = []
        resp = self.client.list_objects_v2(Bucket=self.bucket, Prefix=prefix)
        for item in resp.get("Contents", []):
            out.append(item["Key"])
        return sorted(out)

    def delete(self, key):
        self.client.delete_object(Bucket=self.bucket, Key=key)


class GCSObjectStore(ObjectStore):
    """GCS variant (the natural store next to TPU pods); gated on
    google-cloud-storage."""

    def __init__(self, bucket, client=None):
        if client is None:
            try:
                from google.cloud import storage
            except ImportError as e:
                raise ImportError(
                    "GCSObjectStore needs 'google-cloud-storage'; install "
                    "it or use LocalFSObjectStore") from e
            client = storage.Client()
        self.bucket = client.bucket(bucket) if hasattr(client, "bucket") \
            else bucket
        self._client = client

    def put(self, key, data):
        self.bucket.blob(key).upload_from_string(data)

    def get(self, key):
        return self.bucket.blob(key).download_as_bytes()

    def list_keys(self, prefix=""):
        return sorted(b.name for b in self._client.list_blobs(
            self.bucket, prefix=prefix))

    def delete(self, key):
        self.bucket.blob(key).delete()


class ObjectStoreDataSetIterator(DataSetIterator):
    """Stream DataSets from serialized .npz objects under a store prefix.
    reference: aws/dataset/BaseS3DataSetIterator.java."""

    def __init__(self, store, prefix=""):
        self.store = store
        self.prefix = prefix
        self.keys = [k for k in store.list_keys(prefix)
                     if k.endswith(".npz")]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.keys)

    def next_batch(self):
        from ..streaming.serde import decode_dataset
        key = self.keys[self._pos]
        self._pos += 1
        return decode_dataset(self.store.get(key))

    def reset(self):
        self._pos = 0
