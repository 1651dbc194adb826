from .options import (BaseOptions, EditOptions, TestOptions,  # noqa: F401
                      TrainOptions, configs_from_opt, device_from_opt)
