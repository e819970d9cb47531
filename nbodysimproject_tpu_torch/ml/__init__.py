from .model_zoo import MLP, make_mlp, make_torch_mlp
from .dataset import StabilityDataset
from .data_utils import ScalerUtils, StandardScaler
from .predict import StabilityPredictor, feature_matrix

__all__ = ["MLP", "make_mlp", "make_torch_mlp", "StabilityDataset",
           "ScalerUtils", "StandardScaler", "StabilityPredictor",
           "feature_matrix"]
