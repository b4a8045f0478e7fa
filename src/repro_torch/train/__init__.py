from repro_torch.train.train_step import make_train_step, loss_fn  # noqa: F401
from repro_torch.train.trainer import Trainer  # noqa: F401
from repro_torch.train.cluster import (ClusterTimeModel, TrainCluster,  # noqa: F401
                                       TRAIN_FABRICS, train_fabric)
