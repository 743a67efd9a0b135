"""Training-side helpers the serve chain uses (clustering files, model CMLLR)."""
