from repro_torch.core.elastic.cluster import (
    ClusterConfig,
    ElasticCluster,
    ElasticResult,
    ReplicaSpec,
    ServeRequest,
)
from repro_torch.core.elastic.remesh import (
    elastic_remesh_plan,
    measure_provision_delay,
    provisioned_cluster_config,
    remesh_params,
)

__all__ = ["ClusterConfig", "ElasticCluster", "ElasticResult", "ReplicaSpec",
           "ServeRequest", "elastic_remesh_plan", "measure_provision_delay",
           "provisioned_cluster_config", "remesh_params"]
