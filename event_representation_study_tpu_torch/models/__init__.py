from .backbones import CSPBackboneP6
from .heads import EffiDeHead
from .necks import CSPRepBiFPANNeck_P6
from .yolo import BACKBONES, NECKS, Detector, build_model, init_weights_
