"""Name registries for training types, backends, and federated optimizers.

The port's own copy of ``fedml_tpu/constants.py``, so that the names (and
the configs that use them) are shared. Parity: reference
``python/fedml/constants.py:1-36``.
"""

# --- training types (product lines) ---------------------------------------
FEDML_TRAINING_PLATFORM_SIMULATION = "simulation"
FEDML_TRAINING_PLATFORM_CROSS_SILO = "cross_silo"
FEDML_TRAINING_PLATFORM_CROSS_DEVICE = "cross_device"
FEDML_TRAINING_PLATFORM_CENTRALIZED = "centralized"
FEDML_TRAINING_PLATFORM_DISTRIBUTED = "distributed"

# --- simulation backends ----------------------------------------------------
FEDML_SIMULATION_TYPE_SP = "sp"          # single-process, one XLA program per round
FEDML_SIMULATION_TYPE_TPU = "TPU"        # Parrot-TPU: clients sharded over the mesh
FEDML_SIMULATION_TYPE_NCCL = "NCCL"      # accepted alias for reference configs -> TPU
FEDML_SIMULATION_TYPE_MPI = "MPI"        # accepted alias for reference configs -> TPU

# --- cross-silo scenarios ---------------------------------------------------
CROSS_SILO_SCENARIO_HORIZONTAL = "horizontal"
CROSS_SILO_SCENARIO_HIERARCHICAL = "hierarchical"

# --- communication backends (WAN / control plane) ---------------------------
COMM_BACKEND_LOOPBACK = "LOOPBACK"   # in-process, deterministic (tests)
COMM_BACKEND_GRPC = "GRPC"
COMM_BACKEND_TRPC = "TRPC"           # tensor-socket pipes (TensorPipe parity)
COMM_BACKEND_MQTT_S3 = "MQTT_S3"     # pub/sub control plane + blob store payloads
COMM_BACKEND_MQTT_S3_MNN = "MQTT_S3_MNN"  # same planes; payload = device model FILES
COMM_BACKEND_TPU = "TPU"             # collective plane inside a pod

# --- federated optimizers ---------------------------------------------------
FEDML_FEDERATED_OPTIMIZER_FEDAVG = "FedAvg"
FEDML_FEDERATED_OPTIMIZER_FEDOPT = "FedOpt"
FEDML_FEDERATED_OPTIMIZER_FEDPROX = "FedProx"
FEDML_FEDERATED_OPTIMIZER_FEDNOVA = "FedNova"
FEDML_FEDERATED_OPTIMIZER_SCAFFOLD = "SCAFFOLD"
FEDML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST = "FedAvg_robust"
FEDML_FEDERATED_OPTIMIZER_FEDGAN = "FedGAN"
FEDML_FEDERATED_OPTIMIZER_HIERARCHICAL_FL = "HierarchicalFL"
FEDML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE = "TA"
FEDML_FEDERATED_OPTIMIZER_VERTICAL_FL = "VFL"
FEDML_FEDERATED_OPTIMIZER_SPLIT_NN = "SplitNN"
FEDML_FEDERATED_OPTIMIZER_DECENTRALIZED = "Decentralized"

SUPPORTED_FEDERATED_OPTIMIZERS = [
    FEDML_FEDERATED_OPTIMIZER_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDOPT,
    FEDML_FEDERATED_OPTIMIZER_FEDPROX,
    FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
    FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST,
    FEDML_FEDERATED_OPTIMIZER_HIERARCHICAL_FL,
    FEDML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE,
    FEDML_FEDERATED_OPTIMIZER_VERTICAL_FL,
    FEDML_FEDERATED_OPTIMIZER_SPLIT_NN,
    FEDML_FEDERATED_OPTIMIZER_DECENTRALIZED,
]
