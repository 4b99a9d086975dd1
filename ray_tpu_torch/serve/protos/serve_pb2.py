# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: serve.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bserve.proto\x12\x0craytpu.serve\"n\n\x0cServeRequest\x12\x13\n\x0b\x61pplication\x18\x01 \x01(\t\x12\x12\n\ndeployment\x18\x02 \x01(\t\x12\x0e\n\x06method\x18\x03 \x01(\t\x12\x0f\n\x07payload\x18\x04 \x01(\x0c\x12\x14\n\x0c\x63ontent_type\x18\x05 \x01(\t\"3\n\nServeReply\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12\x14\n\x0c\x63ontent_type\x18\x02 \x01(\t\"\x19\n\x17ListApplicationsRequest\"2\n\x15ListApplicationsReply\x12\x19\n\x11\x61pplication_names\x18\x01 \x03(\t\"\x10\n\x0eHealthzRequest\"\x1f\n\x0cHealthzReply\x12\x0f\n\x07message\x18\x01 \x01(\t2\xb3\x02\n\x0cServeIngress\x12<\n\x04\x43\x61ll\x12\x1a.raytpu.serve.ServeRequest\x1a\x18.raytpu.serve.ServeReply\x12@\n\x06Stream\x12\x1a.raytpu.serve.ServeRequest\x1a\x18.raytpu.serve.ServeReply0\x01\x12^\n\x10ListApplications\x12%.raytpu.serve.ListApplicationsRequest\x1a#.raytpu.serve.ListApplicationsReply\x12\x43\n\x07Healthz\x12\x1c.raytpu.serve.HealthzRequest\x1a\x1a.raytpu.serve.HealthzReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serve_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SERVEREQUEST._serialized_start=29
  _SERVEREQUEST._serialized_end=139
  _SERVEREPLY._serialized_start=141
  _SERVEREPLY._serialized_end=192
  _LISTAPPLICATIONSREQUEST._serialized_start=194
  _LISTAPPLICATIONSREQUEST._serialized_end=219
  _LISTAPPLICATIONSREPLY._serialized_start=221
  _LISTAPPLICATIONSREPLY._serialized_end=271
  _HEALTHZREQUEST._serialized_start=273
  _HEALTHZREQUEST._serialized_end=289
  _HEALTHZREPLY._serialized_start=291
  _HEALTHZREPLY._serialized_end=322
  _SERVEINGRESS._serialized_start=325
  _SERVEINGRESS._serialized_end=632
# @@protoc_insertion_point(module_scope)
