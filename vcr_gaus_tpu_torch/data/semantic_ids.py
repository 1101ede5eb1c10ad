"""Semantic class-id convention (tools/semantic_id.py): label 0 is the
background class the mask-extraction tool (Grounded-SAM prompts, e.g. 'sky.'
outdoors / 'window.floor.' indoors) writes, and the class the meshing stage
zeroes out of the depth maps."""

BACKGROUND = 0
FOREGROUND = 1

# text prompts used by the reference's mask extractor
# (process_data/extract_mask.py:27-30)
PROMPTS = {"outdoor": "sky.", "indoor": "window.floor."}
