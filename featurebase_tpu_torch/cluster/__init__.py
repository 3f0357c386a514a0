from featurebase_tpu_torch.cluster.cluster import Cluster
from featurebase_tpu_torch.cluster.topology import ClusterSnapshot, Node

__all__ = ["Cluster", "ClusterSnapshot", "Node"]
