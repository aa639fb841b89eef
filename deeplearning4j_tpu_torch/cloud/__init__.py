"""Cloud: port of deeplearning4j_tpu/cloud/ (the object stores and the
iterator that feeds their DataSets to `fit`, and cluster provisioning,
whose launch environment starts torch.distributed ranks)."""
from .object_store import (GCSObjectStore, LocalFSObjectStore, ObjectStore,
                           ObjectStoreDataSetIterator, S3ObjectStore)
from .provision import (ClusterProvisioner, ClusterSpec, CommandRunner,
                        LocalCommandRunner, SSHCommandRunner,
                        create_instances_command)

__all__ = ["ClusterProvisioner", "ClusterSpec", "CommandRunner",
           "GCSObjectStore", "LocalCommandRunner", "LocalFSObjectStore",
           "ObjectStore", "ObjectStoreDataSetIterator", "S3ObjectStore",
           "SSHCommandRunner", "create_instances_command"]
