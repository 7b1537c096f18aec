from .trainer import (Callback, CSVLogger, EarlyStopping, Trainer,
                      TrainState, load_params, load_state, save_params,
                      save_state)

__all__ = ["Trainer", "TrainState", "Callback", "CSVLogger", "EarlyStopping",
           "save_params", "load_params", "save_state",
           "load_state"]
