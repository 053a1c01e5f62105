# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: taste_serving.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13taste_serving.proto\x12\rtaste_serving\"x\n\x0fTokenizeRequest\x12\x16\n\x0e\x61udio_features\x18\x01 \x03(\x02\x12\x0e\n\x06n_mels\x18\x02 \x01(\x05\x12\x10\n\x08n_frames\x18\x03 \x01(\x05\x12\x15\n\rasr_token_ids\x18\x04 \x03(\x05\x12\x14\n\x0c\x61sr_word_ids\x18\x05 \x03(\x05\"9\n\x10TokenizeResponse\x12\x0f\n\x07indices\x18\x01 \x03(\x05\x12\x14\n\x0cn_quantizers\x18\x02 \x01(\x05\"\x87\x01\n\x12ReconstructRequest\x12.\n\x06inputs\x18\x01 \x01(\x0b\x32\x1e.taste_serving.TokenizeRequest\x12\x19\n\x11speaker_embedding\x18\x02 \x03(\x02\x12\x18\n\x10max_speech_steps\x18\x03 \x01(\x05\x12\x0c\n\x04seed\x18\x04 \x01(\x04\"a\n\x13ReconstructResponse\x12\r\n\x05pcm16\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\x05\x12\x19\n\x11num_speech_tokens\x18\x03 \x01(\x05\x12\x0b\n\x03rtf\x18\x04 \x01(\x02\"\xd0\x01\n\x0f\x43ompleteRequest\x12\x15\n\rllm_token_ids\x18\x01 \x03(\x05\x12\x14\n\x0cllm_word_ids\x18\x02 \x03(\x05\x12\x13\n\x0bllm_indices\x18\x03 \x03(\x05\x12\x13\n\x0b\x65xtra_words\x18\x04 \x01(\x05\x12\x12\n\ntext_top_p\x18\x05 \x01(\x02\x12\x13\n\x0btaste_top_p\x18\x06 \x01(\x02\x12\x13\n\x0btemperature\x18\x07 \x01(\x02\x12\x1a\n\x12repetition_penalty\x18\x08 \x01(\x02\x12\x0c\n\x04seed\x18\t \x01(\x04\"g\n\x10\x43ompleteResponse\x12\x11\n\ttoken_ids\x18\x01 \x03(\x05\x12\x10\n\x08word_ids\x18\x02 \x03(\x05\x12\x15\n\rtaste_indices\x18\x03 \x03(\x05\x12\x17\n\x0fnum_taste_words\x18\x04 \x01(\x05\"\xc1\x01\n\x11SynthesizeRequest\x12\x15\n\rtaste_indices\x18\x01 \x03(\x05\x12\x0f\n\x07n_words\x18\x02 \x01(\x05\x12\x15\n\rasr_token_ids\x18\x03 \x03(\x05\x12\x14\n\x0c\x61sr_word_ids\x18\x04 \x03(\x05\x12\x19\n\x11speaker_embedding\x18\x05 \x03(\x02\x12\x18\n\x10max_speech_steps\x18\x06 \x01(\x05\x12\x14\n\x0c\x63hunk_tokens\x18\x07 \x01(\x05\x12\x0c\n\x04seed\x18\x08 \x01(\x04\"k\n\x0fSynthesizeChunk\x12\r\n\x05pcm16\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\x05\x12\x0f\n\x07is_last\x18\x03 \x01(\x08\x12\x12\n\nnum_tokens\x18\x04 \x01(\x05\x12\x0f\n\x07n_words\x18\x05 \x01(\x05\"\x88\x02\n\x15\x43ompleteStreamRequest\x12\x30\n\x08\x63omplete\x18\x01 \x01(\x0b\x32\x1e.taste_serving.CompleteRequest\x12\x15\n\rasr_token_ids\x18\x02 \x03(\x05\x12\x14\n\x0c\x61sr_word_ids\x18\x03 \x03(\x05\x12\x19\n\x11speaker_embedding\x18\x04 \x03(\x02\x12\x18\n\x10max_speech_steps\x18\x05 \x01(\x05\x12\x14\n\x0c\x63hunk_tokens\x18\x06 \x01(\x05\x12\x1a\n\x12\x66irst_chunk_tokens\x18\x07 \x01(\x05\x12\x16\n\x0ejd_first_chunk\x18\x08 \x01(\x05\x12\x11\n\tmax_steps\x18\t \x01(\x05\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'taste_serving_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TOKENIZEREQUEST._serialized_start=38
  _TOKENIZEREQUEST._serialized_end=158
  _TOKENIZERESPONSE._serialized_start=160
  _TOKENIZERESPONSE._serialized_end=217
  _RECONSTRUCTREQUEST._serialized_start=220
  _RECONSTRUCTREQUEST._serialized_end=355
  _RECONSTRUCTRESPONSE._serialized_start=357
  _RECONSTRUCTRESPONSE._serialized_end=454
  _COMPLETEREQUEST._serialized_start=457
  _COMPLETEREQUEST._serialized_end=665
  _COMPLETERESPONSE._serialized_start=667
  _COMPLETERESPONSE._serialized_end=770
  _SYNTHESIZEREQUEST._serialized_start=773
  _SYNTHESIZEREQUEST._serialized_end=966
  _SYNTHESIZECHUNK._serialized_start=968
  _SYNTHESIZECHUNK._serialized_end=1075
  _COMPLETESTREAMREQUEST._serialized_start=1078
  _COMPLETESTREAMREQUEST._serialized_end=1342
# @@protoc_insertion_point(module_scope)
