"""Host numpy evaluation (mAP, recall, DOTA).  Importing this package
imports no torch."""

from .class_names import dataset_aliases, get_classes
from .dota import dota_eval
from .mean_ap import average_precision, eval_map, tpfp_default
from .recall import eval_recalls
