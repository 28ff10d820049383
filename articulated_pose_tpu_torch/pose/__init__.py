"""On-device pose fitting: Horn/Umeyama fits, RANSAC, joint LM, pipeline."""
