"""The submap back end: NCC matching, coarse registration, the device
submap bank, pose-graph optimization and refinement."""
