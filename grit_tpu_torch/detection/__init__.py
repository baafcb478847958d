"""Detector pre-training: model, criterion, solver, hooks, data and mAP evaluation."""
