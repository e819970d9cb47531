from .model_zoo import MLP, make_mlp, make_torch_mlp
from .dataset import StabilityDataset
from .data_utils import DataUtils, ScalerUtils, StandardScaler
from .train_mlp import MLPTrainer
from .train_lightgbm import main as train_lightgbm_main, train_gbdt
from .predict import StabilityPredictor, feature_matrix

__all__ = ["MLP", "make_mlp", "make_torch_mlp", "StabilityDataset",
           "DataUtils", "ScalerUtils", "StandardScaler", "MLPTrainer",
           "train_lightgbm_main", "train_gbdt", "StabilityPredictor",
           "feature_matrix"]
