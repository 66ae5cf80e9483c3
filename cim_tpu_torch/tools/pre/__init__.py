"""The offline preprocessing CLIs (``python -m cim_tpu_torch.tools.pre.<name>``):
from COB proposals and images to the trainer's inputs. generate_7_7 (the
SxS proposal pkl, host only), create_cob_iou (per-image IoU and
asymmetric-IoU pkls), AGPL_label_assign (PRM peaks to the label-assignment
pkl) and point_level_label_assign (annotated points to it); the last three
run on the card unless given --device cpu."""
