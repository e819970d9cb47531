from .ic_generator import InitialConditionGenerator, GeneratorConfig
from .specialized import SpecializedGenerators
from .pipeline import (MLTrainingPipeline, diverse_population,
                       headline_population)

__all__ = ["InitialConditionGenerator", "GeneratorConfig",
           "SpecializedGenerators", "MLTrainingPipeline",
           "diverse_population", "headline_population"]
