"""BPNet, the semantic branch's 2D/3D segmentation net."""
from .bpnet import BPNet, BPNetConfig
