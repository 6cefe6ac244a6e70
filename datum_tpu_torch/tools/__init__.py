"""Offline tools (counterpart of datum_tpu/tools): the core pack's writer,
the OBJ parser, the pack compressor and inspector, the BC3 codec, Radiance
.hdr IO and the TrueType font baker.  Each runs as
`python -m datum_tpu_torch.tools.<name>`."""
