"""The per-device config-file contract the native isolation runtime
reads (copy of what ``kubeshare_tpu/nodeconfig`` defines)."""
