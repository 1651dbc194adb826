from .options import (BaseOptions, TestOptions, TrainOptions,  # noqa: F401
                      configs_from_opt, device_from_opt)
