"""Training layer (port of ``redcliff_tpu/train``): the generic and
REDCLIFF-S trainers, the orchestration dispatch and the experiment drivers,
exported under the JAX package's names. Importing the package builds and
loads nothing CUDA-specific."""
from redcliff_tpu_torch.train.driver import (
    kick_off_model_training_experiment,
    rescale_dataset_dependent_coefficients,
    run_coefficient_grid,
    run_folder_name,
    set_up_and_run_experiments,
)
from redcliff_tpu_torch.train.orchestration import (
    call_model_fit_method,
    create_model_instance,
    get_data_for_model_training,
)
from redcliff_tpu_torch.train.redcliff_trainer import (RedcliffTrainConfig,
                                                       RedcliffTrainer)
from redcliff_tpu_torch.train.trainer import (FitResult, TrainConfig, Trainer,
                                              load_model, save_model)

__all__ = [
    "kick_off_model_training_experiment",
    "rescale_dataset_dependent_coefficients",
    "run_coefficient_grid", "run_folder_name", "set_up_and_run_experiments",
    "call_model_fit_method", "create_model_instance",
    "get_data_for_model_training",
    "RedcliffTrainConfig", "RedcliffTrainer",
    "FitResult", "TrainConfig", "Trainer", "load_model", "save_model",
]
