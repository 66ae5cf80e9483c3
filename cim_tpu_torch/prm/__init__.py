"""Peak Response Mapping (port of cim_tpu/prm): the FC-ResNet50 classifier
with peak stimulation, its peak backpropagation (the AGPL preprocessing's
peaks and response maps) and its training."""
